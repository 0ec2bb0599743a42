"""The port's probe and benchmark entry points (uspmv_tpu_torch/scripts/) on
the CPU: each runs with --backend cpu on a tiny input, writes JSON rows that
carry the JAX scripts' keys to --out, and never writes at the repository
root, whose *.jsonl are the JAX package's TPU records. The sweeps' sets and
ap_bench's thresholds are the JAX scripts' own."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.io import generators as jgen

from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.runtime.operator import DeviceUnavailableError
from uspmv_tpu_torch.ops import _build
from uspmv_tpu_torch.scripts import (
    _common,
    ap_bench,
    check_dp_emu,
    gather_probe,
    kernel_ab,
    microbench,
    perf_sweep,
    sparsity_pattern,
    tile_cost,
    validate_campaign,
    value_histogram,
)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {
    "gather_probe": gather_probe,
    "microbench": microbench,
    "tile_cost": tile_cost,
    "perf_sweep": perf_sweep,
    "ap_bench": ap_bench,
    "check_dp_emu": check_dp_emu,
    "validate_campaign": validate_campaign,
}
# tiny arguments that run each entry point in seconds on the CPU
TINY = {
    "gather_probe": ["--elements", "4096", "--x_elems", "2048", "8192",
                     "--tput_blocks", "1", "--reps", "1"],
    "microbench": ["--n", "4096", "--elements", "16384", "--reps", "1"],
    "tile_cost": ["8", "--reps", "1"],
    "perf_sweep": ["Laplace3D,6", "--quick", "--bench_time", "0.0001"],
    "ap_bench": ["Laplace3D,6", "--bench_time", "0.0001"],
    "check_dp_emu": ["Laplace3D,6", "--bench_time", "0.0001"],
    "validate_campaign": ["--quick", "--matrices", "Laplace2D,6"],
}
# the keys of the JAX scripts' JSON rows (scripts/perf_sweep.py:81-93,
# scripts/ap_bench.py:124-132); the other three print text, whose fields
# the port's rows carry under these names
JAX_KEYS = {
    "perf_sweep": {"matrix", "C", "sigma", "value_type", "block_vec_size",
                   "gflops", "effective_gbps", "us_per_iter", "device_beta",
                   "platform", "impl"},
    "ap_bench": {"matrix", "value_type", "gflops", "gbps", "max_rel_err",
                 "nnz_per_precision", "beta", "impl", "platform"},
    "microbench": {"case", "ms_per_iter", "gbps"},
    "tile_cost": {"variant", "us", "ns_per_element", "gflops"},
}


def read_rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def jax_script(name):
    """A module of the JAX package's scripts/, loaded from its file (their
    top levels import nothing of JAX)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_entry_point_runs_on_the_cpu(name, tmp_path, capsys):
    out = tmp_path / f"{name}.jsonl"
    assert SCRIPTS[name].main([*TINY[name], "--backend", "cpu",
                               "--out", str(out)]) == 0
    rows = read_rows(out)
    assert rows
    timed = [r for r in rows if "platform" in r]
    assert timed and all(r["platform"] == "cpu" for r in timed)
    for row in rows:
        assert set(row) >= JAX_KEYS.get(name, set()), row
    assert f"appended to {out}" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_default_output_lies_under_the_build_directory(name):
    default = _common.default_out(name)
    build = REPO / "build" / "uspmv_tpu_torch"
    assert default == build / f"{name}.jsonl"
    assert default.parent != REPO
    args = SCRIPTS[name].build_parser().parse_args(
        [a for a in TINY[name] if not a.startswith("Laplace")])
    assert args.backend == "cuda" and args.out is None


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_cuda_backend_without_a_gpu_raises(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(DeviceUnavailableError):
        SCRIPTS[name].main([*TINY[name], "--out", str(tmp_path / "x.jsonl")])
    assert not (tmp_path / "x.jsonl").exists()


def test_gather_probe_rows(tmp_path):
    rows = gather_probe.run(gather_probe.build_parser().parse_args(
        [*TINY["gather_probe"], "--backend", "cpu",
         "--out", str(tmp_path / "g.jsonl")]))
    table = [r for r in rows if r["probe"] in ("gather1d", "gather2d")]
    assert len(table) == len(gather_probe.SHAPES_1D) + len(
        gather_probe.SHAPES_2D)
    assert all(r["correct"] for r in table)
    assert len([r for r in rows if r["probe"] == "bench_gather"]) == len(
        gather_probe.BENCH_1D)
    assert {r["mode"] for r in rows if r["probe"] == "gather_tput"} == {
        "copy", "gather"}
    sweep = [r for r in rows if r["probe"] == "sweep"]
    # two x sizes x three patterns x two modes, and the in-place copy
    assert len(sweep) == 2 * 3 * 2 + 1
    for r in sweep:
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
        assert (r["library_ms"] is None) == (r["mode"] != "gather_store")
        assert r["rel_err"] <= r["tol"]


def test_tile_cost_rows(tmp_path):
    rows = tile_cost.run(tile_cost.build_parser().parse_args(
        ["8", "--reps", "1", "--backend", "cpu",
         "--out", str(tmp_path / "t.jsonl")]))
    by = {r["variant"]: r for r in rows}
    assert list(by) == [*tile_cost.scs_probe.VARIANTS, "spmv", "unit", "ones"]
    assert by["full"]["bit_equal_to_spmv"]
    assert by["unit"]["rel_err_vs_ones"] < tile_cost.TOL
    # the unit stream moves 4 B per stored element less than explicit ones
    assert by["ones"]["bound_bytes"] - by["unit"]["bound_bytes"] == \
        4 * by["unit"]["n_elements"]
    assert by["bare"]["bound_bytes"] < by["no_x"]["bound_bytes"] < \
        by["full"]["bound_bytes"]
    assert all(r["matrix"] == "Laplace3D,8" for r in rows)


@pytest.mark.parametrize("flags", [[], ["--quick"], ["--bs_only"]])
def test_perf_sweep_sets_are_the_jax_scripts(flags):
    """scripts/perf_sweep.py:49-65."""
    args = perf_sweep.build_parser().parse_args(flags)
    want = {
        (): ([(1, 1), (16, 512), (1024, 1), (1024, 1024)], ["sp", "hp"],
             [1, 4, 8, 16, 32]),
        ("--quick",): ([(1024, 1)], ["sp"], [1, 8]),
        ("--bs_only",): ([(1024, 1)], ["sp"], [1, 4, 8, 16, 32]),
    }[tuple(flags)]
    assert perf_sweep.sweep_sets(args) == want
    assert args.matrix == "Laplace3D,64" and args.bench_time == 1.5


def test_perf_sweep_rows_cover_the_set(tmp_path):
    rows = perf_sweep.run(perf_sweep.build_parser().parse_args(
        ["Laplace3D,6", "--bs_only", "--bench_time", "0.0001",
         "--backend", "cpu", "--out", str(tmp_path / "p.jsonl")]))
    assert [r["block_vec_size"] for r in rows] == [1, 4, 8, 16, 32]
    assert all(r["impl"].startswith("torch-plain") for r in rows)


@pytest.mark.parametrize("tol", [1e-14, 1e-16, 1e-2])
@pytest.mark.parametrize("spec", ["Laplace3D,6", "WideSpectrum,5"])
def test_ap_bench_thresholds_are_the_jax_scripts(spec, tol):
    jax_mod = jax_script("ap_bench")
    name, *args = spec.split(",")
    jm = getattr(jgen, {"Laplace3D": "laplace3d",
                        "WideSpectrum": "wide_spectrum"}[name])(int(args[0]))
    tm = tgen.generate_matrix(spec)
    for fn in ("get_buckets_threshold", "clamp_threshold"):
        j_fn, t_fn = getattr(jax_mod, fn), getattr(ap_bench, fn)
        if fn == "get_buckets_threshold":
            assert t_fn(tm, tol) == j_fn(jm, tol)
        else:
            th = ap_bench.get_buckets_threshold(tm, tol)
            assert t_fn(tm, th) == j_fn(jm, th)


def test_ap_bench_cases_and_errors(tmp_path):
    rows = ap_bench.run(ap_bench.build_parser().parse_args(
        ["Laplace3D,6", "--bench_time", "0.0001", "--backend", "cpu",
         "--out", str(tmp_path / "a.jsonl")]))
    assert [r["value_type"] for r in rows] == [
        "sp", "hp", "dp_emu", "ap[sp_hp]", "ap[dp_sp]", "ap[dp_sp_hp]"]
    err = {r["value_type"]: r["max_rel_err"] for r in rows}
    assert err["dp_emu"] < 1e-14 and err["sp"] < 1e-6
    assert np.isfinite(list(err.values())).all()


def test_microbench_cases_are_the_jax_scripts():
    """scripts/microbench.py's case names, in its order."""
    cases = microbench.make_cases(1024, 8192, torch.device("cpu"))
    assert list(cases) == [
        "stream_mul", "take_1d", "take_mul", "scatter_add", "segsum_sorted",
        "taa_lanes_8xW", "taa_lanes_Kx128", "taa_sublanes_Kx128", "dia_7"]
    with pytest.raises(ValueError, match="unknown cases"):
        microbench.main(["no_such_case", "--backend", "cpu", "--n", "1024",
                         "--elements", "8192"])


# ------------------------------------------------- kernel_ab (GPU only)


def test_kernel_ab_arguments_and_turns(tmp_path):
    libs = kernel_ab.parse_libs(["parent=a/csrc", "change=b"])
    assert list(libs) == ["parent", "change"]
    assert libs["change"] == Path("b")
    for bad in (["parent"], ["=a"], ["p=a", "p=b"]):
        with pytest.raises(ValueError, match="--lib"):
            kernel_ab.parse_libs(bad)
    # parent, change, change, parent: each as often early as late
    assert kernel_ab.turns(["p", "c"], 2) == ["p", "c", "c", "p"] * 2
    # the pieces kernel: work records here, the two-pass design's arguments
    # (parent runs and rows, no records or counters) for an older tree
    assert kernel_ab.pieces_abi(REPO / "uspmv_tpu_torch" / "csrc") \
        == "records"
    (tmp_path / "scs_pieces.cu").write_text("int uspmv_scs_pieces(...);")
    assert kernel_ab.pieces_abi(tmp_path) == "two_pass"
    assert len(kernel_ab._PIECES_ARGTYPES_TWO_PASS) + 4 \
        == len(kernel_ab.scs_pieces._ARGTYPES)
    args = kernel_ab.build_parser().parse_args(["--lib", "a=b"])
    assert args.out is None
    assert args.cases == "sell,packed,solve,pieces,gather"
    assert _common.default_out("kernel_ab").parent \
        == REPO / "build" / "uspmv_tpu_torch"
    with pytest.raises(ValueError, match="unknown"):
        kernel_ab.main(["--lib", "a=b", "--cases", "sell,gemm"])


def test_kernel_ab_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    out = tmp_path / "ab.jsonl"
    with pytest.raises(DeviceUnavailableError):
        kernel_ab.main(["--lib", f"a={REPO / 'uspmv_tpu_torch' / 'csrc'}",
                        "--out", str(out)])
    assert not out.exists()


def test_kernel_resources_reads_cuobjdump(monkeypatch):
    """The registers and local memory per kernel, from cuobjdump's
    -res-usage text (demangled by c++filt where it is installed)."""
    import subprocess

    text = ("Resource usage:\n Common:\n  GLOBAL:0\n"
            " Function _Z6kernAPf:\n  REG:40 STACK:0 SHARED:0 LOCAL:0 "
            "CONSTANT[0]:400 TEXTURE:0 SURFACE:0 SAMPLER:0\n"
            " Function _Z6kernBPd:\n  REG:64 STACK:8 SHARED:1024 LOCAL:16 "
            "CONSTANT[0]:400 TEXTURE:0 SURFACE:0 SAMPLER:0\n")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if cmd[0] == "c++filt":
            out = "kernA(float*)\nkernB(double*)\n"
        else:
            out = text
        return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")

    monkeypatch.setattr(_build, "find_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build.shutil, "which", lambda name: name)
    got = _build.kernel_resources(Path("lib.so"))
    assert calls[0] == ["/cuda/bin/cuobjdump", "-res-usage", "lib.so"]
    assert got == [
        dict(function="kernA(float*)", registers=40, stack=0, shared=0,
             local=0),
        dict(function="kernB(double*)", registers=64, stack=8, shared=1024,
             local=16)]
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert [r["function"] for r in _build.kernel_resources(Path("x"))] \
        == ["_Z6kernAPf", "_Z6kernBPd"]


def test_check_dp_emu_rows(tmp_path):
    rows = check_dp_emu.run(check_dp_emu.build_parser().parse_args(
        ["Laplace3D,8", "--bench_time", "0.0001", "--backend", "cpu",
         "--out", str(tmp_path / "d.jsonl")]))
    by = {r["variant"]: r for r in rows}
    assert list(by) == ["dp_emu", "dp", "scipy"]
    assert by["dp_emu"]["max_rel_err"] < check_dp_emu.MAX_REL_ERR
    assert by["dp"]["max_rel_err"] < check_dp_emu.MAX_REL_ERR
    assert by["dp_emu"]["impl"] == by["dp"]["impl"]
    assert by["dp"]["impl"].startswith("torch-plain-")
    # one kernel, timed once
    assert by["dp_emu"]["gflops"] is None
    assert by["dp_emu"]["same_kernel_as"] == "dp"
    assert by["dp"]["gflops"] > 0 and by["scipy"]["gflops"] > 0
    assert check_dp_emu.build_parser().parse_args([]).matrix == "Laplace3D,96"


def test_validate_campaign_sweep_is_the_jax_scripts(tmp_path, monkeypatch):
    """scripts/validate_campaign.py:72-75: the quick and full sets."""
    monkeypatch.setenv("USPMV_CAMPAIGN_DIR", str(tmp_path))
    for flags, per_matrix in ((["--quick"], 4 * 3 * 2 * 2),
                              ([], 9 * 9 * 4 * 2)):
        args = validate_campaign.build_parser().parse_args(
            [*flags, "--matrices", "A,1", "B,2", "--backend", "cpu"])
        runs = validate_campaign.sweep(args)
        assert len(runs) == 2 * per_matrix + 3 + 3
        assert all(argv[argv.index("-mtx_out") + 1] == str(tmp_path)
                   for _, argv in runs)
    args = validate_campaign.build_parser().parse_args(["--shards", "4"])
    runs = validate_campaign.sweep(args)
    assert {m for m, _ in runs[:-6]} == set(validate_campaign.DEFAULT_MATRICES)
    assert all(argv[argv.index("-n_shards") + 1] == "4"
               for _, argv in runs[:-6])


def test_validate_campaign_runs_sharded_and_counts_failures(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("USPMV_CAMPAIGN_DIR", str(tmp_path))
    out = tmp_path / "v.jsonl"
    assert validate_campaign.main(
        ["--quick", "--matrices", "Laplace2D,8", "--shards", "2",
         "--backend", "cpu", "--out", str(out)]) == 0
    rows = read_rows(out)
    assert len(rows) == 48 + 6 and all(r["rc"] == 0 for r in rows)
    assert {r["impl"].split("[")[1].split("-")[0] for r in rows} == {
        "torch"}  # torch-plain-... and the CSR comparison torch-csr-...
    # a failing run is counted, and the campaign exits 1
    monkeypatch.setattr(validate_campaign, "sweep", lambda args: [
        ("NoSuchModel,4", ["NoSuchModel,4", "crs", "-mode", "s",
                           "-backend", "cpu"])])
    assert validate_campaign.main(["--backend", "cpu", "--out",
                                   str(tmp_path / "f.jsonl")]) == 1
    assert read_rows(tmp_path / "f.jsonl")[0]["rc"] == 3


@pytest.mark.parametrize("spec", ["Laplace2D,12", "StokesSaddle,3",
                                  "Hubbard,n_sites=6,n_fermions=3,U=1.3"])
def test_sparsity_pattern_and_value_histogram(spec, tmp_path, capsys):
    jax_pattern = jax_script("sparsity_pattern")
    tm = tgen.generate_matrix(spec)
    jm = jgen.generate_matrix(spec)
    for bins in (4, 64, 512):
        assert np.array_equal(sparsity_pattern.density_grid(tm, bins),
                              jax_pattern.density_grid(jm, bins))
    pgm = tmp_path / "p.pgm"
    assert sparsity_pattern.main([spec, "-o", str(pgm), "-b", "16"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {pgm}"
    assert pgm.read_bytes().startswith(b"P5\n16 16\n255\n")
    out = tmp_path / "v.png"
    assert value_histogram.main([spec, "-o", str(out), "-b", "8"]) == 0
    text = capsys.readouterr().out
    assert text.startswith(f"matrix: {tm.n_rows} x {tm.n_cols}")
    vc, vn, lengths, rn = value_histogram.histograms(tm, 8)
    assert vn.sum() == int((tm.values != 0).sum())
    assert rn.sum() == tm.n_rows
