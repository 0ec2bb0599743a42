"""The auxiliary modules of uspmv_tpu_torch against the JAX package, on the
CPU: the ScaMaC-style models and the Stokes saddle point (bit-equal), the
generator router, the matrix statistics (text-equal), the sanity checker's
dumps (text-equal) and checks, the profiling hooks (region names equal; a
Chrome trace written on the CPU) and -output_sparsity (byte-equal files
with heavy-row splitting off; with it on, equal as multisets of (row, col,
value) once the JAX operator's virtual rows are mapped to their parents),
for the single-device and the sharded operator. The JAX operators run
their XLA path (use_pallas=False), whose SCS is the user's (C, sigma)."""

import dataclasses
import glob
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats import stats as jstats
from uspmv_tpu.formats.coo import split_heavy_rows as j_split
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.io import scamac as jscamac
from uspmv_tpu.parallel.distributed import (
    DistributedSpmvOperator as JDistributed,
)
from uspmv_tpu.runtime import profiling as jprof
from uspmv_tpu.runtime import sanity as jsanity
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats import stats as tstats
from uspmv_tpu_torch.formats.scs import convert_to_scs
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.io import scamac as tscamac
from uspmv_tpu_torch.io.mmio import read_mtx
from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
from uspmv_tpu_torch.parallel.halo import build_halo_plan
from uspmv_tpu_torch.parallel.partition import seg_work_sharing
from uspmv_tpu_torch.runtime import profiling as tprof
from uspmv_tpu_torch.runtime import sanity as tsanity
from uspmv_tpu_torch.runtime.operator import SpmvOperator


def assert_same(a, b):
    """Bit-equal COO: sizes, flags, index arrays and the values' bits."""
    assert (a.n_rows, a.n_cols, a.nnz, a.is_sorted, a.is_symmetric) == (
        b.n_rows, b.n_cols, b.nnz, b.is_sorted, b.is_symmetric)
    for f in ("I", "J", "values"):
        u, v = getattr(a, f), getattr(b, f)
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes(), f


# every model at a small size, random parts (ranpot, disorder, fields) on
SCAMAC_SPECS = [
    "Anderson,Lx=5,Ly=4,Lz=3,disorder=4.5,seed=3",
    "anderson,L=4,pbc=1",
    "Hubbard,n_sites=8,n_fermions=4,U=1.3",
    "Hubbard,n_sites=7,n_fermions=3,t=0.5,U=2,ranpot=0.4,seed=5,pbc=1",
    "hubbard,n_sites=6,n_fermions=3,boundary_conditions=periodic",
    "SpinChainXXZ,L=8,Jxy=0.7,Jz=1.2,Bz=0.3,seed=2",
    "spinchainxxz,L=6,pbc=1",
    "FreeFermionChain,n_sites=10,n_fermions=4,ranpot=1,pbc=1",
    "freefermionchain,n_sites=6,n_fermions=0",
    "Harmonic,n_bos=50,omega=0.5,lambda=0.25",
    "SpinChainXY,L=7,Jx=1,Jy=0.5,Bz=0.2,pbc=1",
    "spinchainxy,L=5,Jx=1,Jy=1",
    "BoseHubbard,n_sites=5,n_bosons=4,t=0.5,U=2,pbc=1",
    "Tridiagonal,n=30,diag=3,off=-0.5",
]


@pytest.mark.parametrize("spec", SCAMAC_SPECS)
def test_scamac_models_bit_equal(spec):
    assert_same(jscamac.scamac_generate(spec), tscamac.scamac_generate(spec))
    # and through the generator router, any case
    assert_same(jgen.generate_matrix(spec), tgen.generate_matrix(spec))


@pytest.mark.parametrize("nx", [4, 5, 6, 8])
def test_stokes_saddle_bit_equal(nx):
    assert_same(jgen.stokes_saddle(nx), tgen.stokes_saddle(nx))
    assert_same(jgen.generate_matrix(f"StokesSaddle,{nx}"),
                tgen.generate_matrix(f"StokesSaddle,{nx}"))
    m = tgen.stokes_saddle(nx)
    counts = np.bincount(m.I, minlength=m.n_rows)
    assert m.n_rows == 4 * nx ** 3 and counts.min() >= 7


def test_scamac_models_listed_alike():
    assert tscamac.scamac_models() == jscamac.scamac_models()


@pytest.mark.parametrize("spec", [
    "NoSuchModel,3",
    "Hubbard,n_sites",  # an option without a value
    "Hubbard,n_sites=21",  # over the size guard
    "Hubbard,n_sites=20,n_fermions=10",  # over the 2^28 nnz estimate
    "Hubbard,n_sites=4,n_fermions=6",
    "Hubbard,n_sites=4,colour=red",  # an unknown option
    "SpinChainXXZ,L=25",
    "BoseHubbard,n_sites=30,n_bosons=30",
    "Harmonic,n_bos=0",
])
def test_generator_router_errors_alike(spec):
    with pytest.raises(Exception) as jerr:
        jgen.generate_matrix(spec)
    with pytest.raises(Exception) as terr:
        tgen.generate_matrix(spec)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def test_scamac_parse_spec_alike():
    for spec in ["Hubbard, n_sites = 6 ,U=1.5,pbc=periodic", "Harmonic"]:
        assert tscamac._parse_spec(spec) == jscamac._parse_spec(spec)
    for spec in ["", " , "]:
        with pytest.raises(ValueError, match="empty ScaMaC spec"):
            tscamac._parse_spec(spec)


def with_empty_rows(mod):
    m = mod.random_imbalanced(300, 4, seed=3)
    keep = m.I % 7 != 0
    return dataclasses.replace(m, I=m.I[keep], J=m.J[keep],
                               values=m.values[keep], nnz=int(keep.sum()))


STATS_MATRICES = {
    "laplace2d": lambda g: g.laplace2d(9),
    "stokes": lambda g: g.stokes_saddle(4),
    "hubbard": lambda g: g.generate_matrix("Hubbard,n_sites=6,n_fermions=3"),
    "empty_rows": with_empty_rows,
    "wide": lambda g: g.wide_spectrum(3),
}


@pytest.mark.parametrize("name", sorted(STATS_MATRICES))
def test_matrix_stats_text_equal(name):
    jm, tm = STATS_MATRICES[name](jgen), STATS_MATRICES[name](tgen)
    js, ts = jstats.get_matrix_stats(jm), tstats.get_matrix_stats(tm)
    assert ts.summary() == js.summary()
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    v = np.concatenate([np.zeros(3), np.arange(1.0, 70.0)])
    assert tstats.log2_histogram(v) == jstats.log2_histogram(v)


def test_cli_matrix_stats_prints_summary_before_device_work(capsys,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # -backend cuda on a host without a card: the summary, rc 0
    assert cli.main(["StokesSaddle,4", "scs", "-matrix_stats"]) == 0
    out = capsys.readouterr().out.strip()
    assert out == jstats.get_matrix_stats(jgen.stokes_saddle(4)).summary()


VECTORS = {
    "f64": lambda r: r.standard_normal(50),
    "f32 short": lambda r: r.standard_normal(7).astype(np.float32),
    "rowwise": lambda r: r.standard_normal((40, 3)),
    "ints": lambda r: np.arange(100.0),
}


def test_sanity_dumps_text_equal(tmp_path):
    rng = np.random.default_rng(4)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jc = jsanity.SanityChecker(str(tmp_path / "j"), rank=1, max_elems=12)
    tc = tsanity.SanityChecker(str(tmp_path / "t"), rank=1, max_elems=12)
    for name, make in VECTORS.items():
        v = make(rng)
        jc.dump_vector(name, v)
        tc.dump_vector(name, torch.from_numpy(v))  # a tensor is accepted
        jc.dump_vector(name + " n", v, n_rows=3)
        tc.dump_vector(name + " n", v, n_rows=3)
    x, y = rng.standard_normal(20), rng.standard_normal(20)
    jc.dump_stage("before_solve", x=x, y=y)
    tc.dump_stage("before_solve", x=x, y=y)
    text = (tmp_path / "t" / "uspmv_debug_rank1.log").read_text()
    assert text == (tmp_path / "j" / "uspmv_debug_rank1.log").read_text()
    assert text.count("\n") >= 2 * len(VECTORS) + 2
    # a new checker starts a new file; a disabled one writes nothing
    tsanity.SanityChecker(str(tmp_path / "t"), rank=1)
    assert not (tmp_path / "t" / "uspmv_debug_rank1.log").exists()
    off = tsanity.SanityChecker(str(tmp_path / "t"), enabled=False)
    off.dump_vector("x", x)
    off.check_finite("x", np.array([np.nan]))
    assert not os.path.exists(off.path)


def test_sanity_checks_raise_alike(tmp_path):
    jc = jsanity.SanityChecker(str(tmp_path))
    tc = tsanity.SanityChecker(str(tmp_path))
    cases = [
        ("check_perm", (np.array([2, 0, 1]),)),
        ("check_perm", (np.array([0, 1, 1]),)),
        ("check_perm", (np.array([0, 3, 1]),)),
        ("check_perm", (np.array([0, 1]), 3)),
        ("check_finite", ("y", np.array([1.0, np.inf, 2.0]))),
        ("check_finite", ("y", np.array([[1.0, 2.0], [np.nan, 0.0]]))),
        ("check_finite", ("y", np.ones(4))),
    ]
    for method, args in cases:
        try:
            getattr(jc, method)(*args)
            want = None
        except AssertionError as e:
            want = str(e)
        if want is None:
            getattr(tc, method)(*args)
        else:
            with pytest.raises(AssertionError) as got:
                getattr(tc, method)(*args)
            assert str(got.value) == want


def test_sanity_scs_padding_and_halo_plan(tmp_path):
    tc = tsanity.SanityChecker(str(tmp_path))
    m = tgen.random_imbalanced(500, 5, seed=2)
    scs = convert_to_scs(m, 8, 16)
    tc.check_scs_padding(scs)
    jsanity.SanityChecker(str(tmp_path)).check_scs_padding(scs)
    bad = dataclasses.replace(scs, values=scs.values.copy())
    bad.values[np.flatnonzero(bad.padding_mask())[0]] = 1.0
    with pytest.raises(AssertionError, match="padding slot"):
        tc.check_scs_padding(bad)
    # the sharded operator's plan: every index where it belongs
    op = DistributedSpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=4, value_type="dp",
               backend="cpu", n_shards=4), tgen.laplace2d(12))
    plan = op.halo_plans["dp"]
    assert plan.offsets
    tc.check_halo_plan(plan)
    d = plan.offsets[0]
    broken = dataclasses.replace(
        plan, send_gather_idx={**plan.send_gather_idx})
    broken.send_gather_idx[d] = plan.send_gather_idx[d].copy()
    broken.send_gather_idx[d][0, 0] = plan.n_rows_padded[0]
    with pytest.raises(AssertionError, match="send idx out of local range"):
        tc.check_halo_plan(broken)
    broken = dataclasses.replace(
        plan, recv_scatter_idx={**plan.recv_scatter_idx})
    broken.recv_scatter_idx[d] = plan.recv_scatter_idx[d].copy()
    broken.recv_scatter_idx[d][1, 0] = 0
    with pytest.raises(AssertionError, match="recv idx outside the halo"):
        tc.check_halo_plan(broken)
    # a plan built directly checks too
    ws, _ = seg_work_sharing(tgen.laplace2d(10), 2, "seg-rows")
    scs_list = [convert_to_scs(tgen.laplace2d(10).slice_rows(
        int(ws[r]), int(ws[r + 1])), 4, 1) for r in range(2)]
    tc.check_halo_plan(build_halo_plan(scs_list, ws))


def test_cli_debug_writes_dumps_and_validates(tmp_path, capsys):
    rc = cli.main(["Laplace2D,12", "scs", "-c", "8", "-sp", "-mode", "s",
                   "-rev", "3", "-debug", "1", "-backend", "cpu",
                   "-mtx_out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "[debug] sanity dumps ->" in out and "[OK]" in out
    text = (tmp_path / "uspmv_debug_rank0.log").read_text().splitlines()
    assert text[0].startswith("[rank 0] before_solve.x: shape=(144,)")
    assert "head=[5. 5. 5." in text[0]
    assert any(ln.startswith("[rank 0] after_solve.y: shape=(144,)")
               for ln in text)


MARKER_CONFIGS = [
    dict(kernel_format=f, block_vec_size=bs, value_type=vt)
    for f in ("crs", "scs") for bs in (1, 4)
    for vt in ("dp", "sp", "hp", "ap[dp_sp]", "ap[dp_sp_hp]")
]


@pytest.mark.parametrize("kw", MARKER_CONFIGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_kernel_marker_name_equal(kw):
    C = 1 if kw["kernel_format"] == "crs" else 8
    kw = dict(kw, chunk_size=C, sigma=1)
    assert tprof.kernel_marker_name(Config(**kw)) == \
        jprof.kernel_marker_name(JConfig(**kw))


def test_marker_and_trace_on_the_cpu(tmp_path, capsys):
    name = "spmv_scs_benchmark"
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.marker(name):
            a = torch.arange(1000.0)
            (a * 2).sum()
    assert name in tprof.registered_markers()
    path = tprof.last_trace_path()
    assert os.path.dirname(path) == str(tmp_path / "prof")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == name for e in events)
    # logdir None: the host timing line
    with tprof.trace(None):
        pass
    assert capsys.readouterr().out.startswith(
        "[uspmv profiling] region took ")
    # disabled: nothing written, nothing printed
    with tprof.trace(str(tmp_path / "off"), enabled=False):
        with tprof.marker("never", enabled=False):
            pass
    assert not (tmp_path / "off").exists()
    assert "never" not in tprof.registered_markers()
    assert capsys.readouterr().out == ""
    tprof.register_marker("pre")
    assert "pre" in tprof.registered_markers()


def test_cli_log_prof_writes_a_trace_of_the_bench(tmp_path, capsys):
    rc = cli.main(["Laplace2D,16", "scs", "-c", "8", "-sp", "-mode", "b",
                   "-bench_time", "0.001", "-backend", "cpu", "-log_prof",
                   str(tmp_path / "prof"), "-mtx_out", str(tmp_path)])
    assert rc == 0 and "GFLOP/s" in capsys.readouterr().out
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "spmv_scs_benchmark" in names


# ------------------------------------------------------------ output_sparsity

def quiet(cls, cfg, mtx):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls.from_mtx(cfg, mtx)


def triples(path, parent=None, n_real=None):
    """Sorted (row, col, value) of an .mtx file; virtual rows (>= n_real)
    mapped to their parents."""
    m = read_mtx(str(path), require_square=False, native=False)
    I = m.I.astype(np.int64)
    if parent is not None:
        virt = I >= n_real
        I[virt] = parent[I[virt] - n_real]
    order = np.lexsort((m.values, m.J, I))
    return I[order], m.J[order], m.values[order]


SPARSITY = {
    "sp-scs": dict(value_type="sp", chunk_size=8, sigma=16),
    "dp-crs": dict(value_type="dp", kernel_format="crs", chunk_size=1,
                   sigma=1),
    "hp-scs": dict(value_type="hp", chunk_size=32, sigma=1),
    "ap-dp-sp": dict(value_type="ap[dp_sp]", ap_threshold_1=0.8,
                     chunk_size=8, sigma=4),
    "ap-3way": dict(value_type="ap[dp_sp_hp]", ap_threshold_1=0.8,
                    ap_threshold_2=0.2, chunk_size=8, sigma=4),
}


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("case", sorted(SPARSITY))
def test_dump_sparsity_single_device(tmp_path, case, split):
    kw = dict(kernel_format="scs", backend="cpu",
              split_rows_threshold=6 if split else -1)
    kw.update(SPARSITY[case])
    jm = jgen.random_imbalanced(700, 5, seed=9)
    tm = tgen.random_imbalanced(700, 5, seed=9)
    jop = quiet(JOperator, JConfig(use_pallas=False, **kw), jm)
    op = quiet(SpmvOperator, Config(**kw), tm)
    # CRS splits no rows (no chunk padding to bound), in both packages
    split = split and kw["chunk_size"] > 1
    assert bool(op.pieces) == split
    assert (next(iter(jop.scs.values())).n_rows > tm.n_rows) == split
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpaths = jop.dump_sparsity(str(tmp_path / "j"))
    tpaths = op.dump_sparsity(str(tmp_path / "t"))
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths]
    parent = j_split(jm, 6)[1] if split else None
    total = 0
    for jp, tp in zip(jpaths, tpaths):
        if not split:
            assert open(tp, "rb").read() == open(jp, "rb").read()
        got = triples(tp)
        want = triples(jp, parent, tm.n_rows)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        total += got[0].size
    # the files hold every nonzero of the matrix once
    assert total == int((tm.values != 0).sum())


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("overlap", [True, False])
def test_dump_sparsity_sharded(tmp_path, split, overlap):
    kw = dict(kernel_format="scs", chunk_size=8, sigma=1, value_type="sp",
              backend="cpu", n_shards=4, overlap_comm=overlap,
              split_rows_threshold=6 if split else -1)
    jm = jgen.random_imbalanced(600, 6, seed=21)
    tm = tgen.random_imbalanced(600, 6, seed=21)
    # the JAX XLA path splits no rows per shard: its files are the
    # unsplit reference for both
    jop = JDistributed.from_mtx(
        JConfig(use_pallas=False, **dict(kw, split_rows_threshold=-1)), jm)
    op = DistributedSpmvOperator.from_mtx(Config(**kw), tm)
    assert (op.n_pieces() > 0) == split
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpaths = jop.dump_sparsity(str(tmp_path / "j"))
    tpaths = op.dump_sparsity(str(tmp_path / "t"))
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths] == \
        [f"sp_local_scs_rank{r}.mtx" for r in range(4)]
    for jp, tp in zip(jpaths, tpaths):
        if not split:
            assert open(tp, "rb").read() == open(jp, "rb").read()
        for a, b in zip(triples(tp), triples(jp)):
            assert np.array_equal(a, b)


def test_cli_output_sparsity_files_hold_the_matrix(tmp_path, capsys):
    spec = "Hubbard,n_sites=6,n_fermions=3,U=1.3"
    rc = cli.main([spec, "scs", "-c", "8", "-s", "16", "-sp",
                   "-split_rows_threshold", "4", "-output_sparsity",
                   "-backend", "cpu", "-mtx_out", str(tmp_path)])
    assert rc == 0
    assert capsys.readouterr().out.strip() == \
        f"wrote {tmp_path / 'sp_local_scs.mtx'}"
    m = tgen.generate_matrix(spec)
    keep = m.values != 0  # explicit zeros are dropped, as in the reference
    v = m.values.astype(np.float32)[keep]
    order = np.lexsort((v, m.J[keep], m.I[keep]))
    I, J, V = triples(tmp_path / "sp_local_scs.mtx")
    # the file prints the f32 values to 16 digits: equal once rounded back
    assert np.array_equal(I, m.I[keep][order])
    assert np.array_equal(J, m.J[keep][order])
    assert np.array_equal(V.astype(np.float32), v[order])


def test_router_names():
    # structured generators by their exact name; ScaMaC models in any case
    with pytest.raises(ValueError, match="unknown generator"):
        tgen.generate_matrix("laplace3d,4")
    spec = "HUBBARD,n_sites=5,n_fermions=2"
    assert_same(jgen.generate_matrix(spec), tgen.generate_matrix(spec))
