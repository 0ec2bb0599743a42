"""Row-sharded SpMV in uspmv_tpu_torch against the JAX package, on the CPU.

The port's ``DistributedSpmvOperator`` runs its R shards on one device
(here the CPU, through the plain PyTorch versions of its kernels); the JAX
operator runs ``Config(backend="cpu", use_pallas=False)`` on the
8-virtual-device CPU mesh (tests/conftest.py). Both get the same matrix and
the same x (numpy, from a seed) and are compared through ``to_host``,
against each other and against scipy in f64, for every comm mode, row
partitioner, shard count, layout and precision the port runs, with and
without the overlap split, with heavy rows split per shard (which the JAX
XLA path does not do), and with the exchange skipped (``comm_halos=0``) or
unpacked (``no_pack``). The communication volumes must equal the JAX
plan's. One case runs the JAX lane-tile path in interpret mode.

Tolerances, max|y - ref| / max|ref|: against JAX, 1e-12 where the sums are
in f64 and 1e-5 in f32 (the same stored values, summed in another order);
against scipy, the reference's 1e-12 (dp), 1e-5 (sp) and 1e-2 (hp, bf16
values against the f64 matrix), the lowest precision of an adaptive mix
setting it. Integer x on the integer-valued Laplacians makes every sum
exact, so there the two packages must agree bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats.coo import MtxData as JMtxData
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.parallel.distributed import (
    DistributedSpmvOperator as JDistributed,
)

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.coo import MtxData
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.device_format import DevicePacked
from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator
from uspmv_tpu_torch.runtime import operator as top
from uspmv_tpu_torch.runtime.bench import bench_solve, bench_spmv
from uspmv_tpu_torch.runtime.report import format_bench_block
from uspmv_tpu_torch.runtime.validate import validate_solve

TOL = {"dp": 1e-12, "sp": 1e-5, "hp": 1e-2}
JAX_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}

MATRICES = {
    "laplace2d(16)": lambda g, cls: g.laplace2d(16),
    "laplace2d(20)": lambda g, cls: g.laplace2d(20),
    "random_imbalanced(600,6)": lambda g, cls: g.random_imbalanced(
        600, 6, seed=21),
    "fem_tet3d(4)": lambda g, cls: g.fem_tet3d(4),
}


def both(name):
    return MATRICES[name](jgen, JMtxData), MATRICES[name](tgen, MtxData)


def lowest(value_type):
    return Config(value_type=value_type).ap_precisions[-1]


def rel(a, b):
    b = np.asarray(b, dtype=np.float64)
    return np.abs(np.asarray(a, dtype=np.float64) - b).max() / np.abs(b).max()


def run_both(name, x=None, seed=0, **kw):
    """(JAX operator, port operator, JAX y, port y, scipy y) of one SpMV."""
    jm, tm = both(name)
    jop = JDistributed.from_mtx(
        JConfig(backend="cpu", use_pallas=False, **kw), jm)
    op = DistributedSpmvOperator.from_mtx(Config(backend="cpu", **kw), tm)
    if x is None:
        bs = kw.get("block_vec_size", 1)
        x = np.random.default_rng(seed).standard_normal(
            (tm.n_rows, bs) if bs > 1 else tm.n_rows)
    jy = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    y = op.to_host(op.spmv(op.make_x(x)))
    return jop, op, jy, y, tm.to_scipy().tocsr() @ x


def check(jop, op, jy, y, ref, value_type):
    assert rel(y, ref) <= TOL[lowest(value_type)], rel(y, ref)
    assert rel(y, jy) <= JAX_TOL[op.working_dtype], rel(y, jy)
    assert op.comm_volume_per_spmv() == jop.comm_volume_per_spmv()
    assert op.comm_volume_per_host() == jop.comm_volume_per_host()


@pytest.mark.parametrize("seg", ["seg-rows", "seg-nnz", "seg-metis"])
@pytest.mark.parametrize("comm_mode", ["bulkvec", "graphtopo", "allgather"])
def test_comm_modes_and_partitioners_match_jax(comm_mode, seg):
    r = run_both("laplace2d(16)", kernel_format="scs", chunk_size=4, sigma=8,
                 value_type="dp", n_shards=4, comm_mode=comm_mode,
                 seg_method=seg)
    check(*r, "dp")
    jop, op = r[0], r[1]
    assert np.array_equal(op.work_sharing, jop.work_sharing)
    assert (op.global_perm is None) == (jop.global_perm is None)
    assert op.per_shard_nnz() == jop.per_shard_nnz()
    assert (op.groups[0].exchanges["dp"] is None) == (comm_mode == "allgather")


@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("fmt,C,value_type", [("crs", 1, "dp"),
                                              ("scs", 8, "sp")])
def test_shard_counts_match_jax(R, fmt, C, value_type):
    r = run_both("laplace2d(20)", kernel_format=fmt, chunk_size=C, sigma=1,
                 value_type=value_type, n_shards=R)
    check(*r, value_type)
    op = r[1]
    assert op.R == R and len(op.shard_perms) == R
    assert op.impl_name() == f"torch-plain-dist{R}-scs-{value_type}"
    if R == 1:
        assert op.comm_volume_per_spmv()[value_type]["real"] == 0


@pytest.mark.parametrize("overlap", [True, False])
def test_overlap_split_matches_jax(overlap):
    r = run_both("random_imbalanced(600,6)", kernel_format="scs",
                 chunk_size=8, sigma=16, value_type="dp", n_shards=4,
                 seg_method="seg-nnz", overlap_comm=overlap,
                 split_rows_threshold=-1)
    check(*r, "dp")
    op = r[1]
    assert op.overlap == overlap
    halo = [sh.halo for sh in op.streams["dp"] if sh.halo is not None]
    assert bool(halo) == overlap
    stored = sum(d.nnz for d in op._devs("dp"))
    assert stored == r[0].nnz
    if overlap:
        assert 0 < sum(d.nnz for d in halo) < stored


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("layout,comm_mode", [("rowwise", "bulkvec"),
                                              ("colwise", "singlevec"),
                                              ("colwise", "allgather")])
def test_block_vectors_match_jax(layout, comm_mode, overlap):
    r = run_both("laplace2d(16)", kernel_format="scs", chunk_size=4, sigma=8,
                 value_type="sp", n_shards=4, block_vec_size=4,
                 vector_layout=layout, comm_mode=comm_mode,
                 overlap_comm=overlap)
    check(*r, "sp")
    op = r[1]
    assert op.make_x().shape == op.x_shape()
    L = op.lengths["sp"]
    assert op.x_shape() == ((4, 4, L) if layout == "colwise" else (4, L, 4))


AP_CASES = {
    # Laplace's diagonal (4) -> dp, the -1 off-diagonals -> sp
    "ap[dp_sp]": dict(name="laplace2d(16)", ap_threshold_1=2.0),
    # standard-normal values over three classes
    "ap[dp_sp_hp]": dict(name="random_imbalanced(600,6)", ap_threshold_1=1.0,
                         ap_threshold_2=0.3),
    "ap[sp_hp]": dict(name="random_imbalanced(600,6)", ap_threshold_1=0.5),
}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("value_type", sorted(AP_CASES))
def test_adaptive_precision_matches_jax(value_type, overlap):
    kw = dict(AP_CASES[value_type])
    name = kw.pop("name")
    r = run_both(name, kernel_format="scs", chunk_size=8, sigma=4,
                 value_type=value_type, n_shards=4, seg_method="seg-nnz",
                 overlap_comm=overlap, split_rows_threshold=-1, **kw)
    check(*r, value_type)
    op = r[1]
    precs = Config(value_type=value_type).ap_precisions
    assert list(op.lengths) == list(precs)
    assert set(op.groups[0].xbufs) == set(precs[1:])
    assert all(op.nnz_per_precision()[p] > 0 for p in precs)
    assert op.nnz_per_precision() == r[0].nnz_per_precision()


def test_hp_matches_jax():
    check(*run_both("laplace2d(16)", kernel_format="scs", chunk_size=8,
                    sigma=1, value_type="hp", n_shards=4), "hp")


SPLIT_CASES = [
    dict(value_type="sp", split_rows_threshold=4),
    dict(value_type="dp", split_rows_threshold=0, chunk_size=32),
    dict(value_type="dp", split_rows_threshold=4, comm_mode="allgather"),
    dict(value_type="sp", split_rows_threshold=4, block_vec_size=2,
         vector_layout="colwise"),
    dict(value_type="ap[dp_sp]", split_rows_threshold=4, ap_threshold_1=1.0,
         equilibrate=True),
    dict(value_type="dp", split_rows_threshold=4, mixed_tiles=True),
]


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_rows_split_per_shard_match_jax(case):
    """The port splits each shard's heavy rows into pieces (read after the
    exchange: their columns are in the plan as extra columns); the JAX XLA
    path keeps them whole. y and the comm volume must not change."""
    kw = dict(dict(kernel_format="scs", chunk_size=8, sigma=1, n_shards=4,
                   seg_method="seg-nnz"), **SPLIT_CASES[case])
    jop, op, jy, y, ref = run_both("random_imbalanced(600,6)", **kw)
    assert op.n_pieces() > 0 and op.split_threshold > 0
    assert "+pieces" in op.impl_name()
    assert sum(op.per_shard_nnz()) == op.nnz
    if kw.get("mixed_tiles"):
        assert op.is_packed()
    assert rel(y, jy) <= JAX_TOL[op.working_dtype]
    assert op.comm_volume_per_spmv() == jop.comm_volume_per_spmv()
    if not kw.get("equilibrate"):
        assert rel(y, ref) <= 3 * TOL[lowest(kw["value_type"])]


def test_tier_is_chosen_per_struct():
    """Packed row groups where a shard's part has a low fill beta, SELL-C-
    sigma elsewhere, as on one device: at C=32 the interior parts of a
    Laplacian fill their chunks, the halo parts (boundary rows) do not."""
    _, tm = both("laplace2d(16)")
    op = DistributedSpmvOperator.from_mtx(Config(
        backend="cpu", kernel_format="scs", chunk_size=32, sigma=1,
        value_type="sp", n_shards=4, seg_method="seg-nnz",
        split_rows_threshold=-1), tm)
    devs = op._devs("sp")
    sell = [d for d in devs if not isinstance(d, DevicePacked)]
    assert sell and len(sell) < len(devs)
    assert all(d.device_beta >= top.PACKED_BETA_CUTOFF for d in sell)
    assert all(not isinstance(sh.main, DevicePacked)
               for sh in op.streams["sp"])
    assert op.is_packed() and "scs+packed" in op.impl_name()


def integer_x(n, seed=3):
    return np.random.default_rng(seed).integers(-4, 5, n).astype(np.float64)


@pytest.mark.parametrize("overlap", [True, False])
def test_comm_halos_off_is_wrong_in_both(overlap):
    _, tm = both("laplace2d(16)")
    x = integer_x(tm.n_rows)
    jop, op, jy, y, ref = run_both(
        "laplace2d(16)", x=x, kernel_format="scs", chunk_size=4, sigma=4,
        value_type="dp", n_shards=4, comm_halos=False, overlap_comm=overlap)
    assert not np.allclose(jy, ref) and not np.allclose(y, ref)
    assert np.array_equal(y, jy)  # exact sums: the same wrong y


@pytest.mark.parametrize("overlap", [True, False])
def test_no_pack_bit_equal_to_jax(overlap):
    _, tm = both("laplace2d(16)")
    x = integer_x(tm.n_rows)
    jop, op, jy, y, ref = run_both(
        "laplace2d(16)", x=x, kernel_format="scs", chunk_size=4, sigma=4,
        value_type="dp", n_shards=4, no_pack=True, overlap_comm=overlap)
    assert not np.allclose(y, ref)
    assert np.array_equal(y, jy)


@pytest.mark.parametrize("seg", ["seg-rows", "seg-metis"])
def test_solve_validates_and_matches_jax(seg):
    jm, tm = both("fem_tet3d(4)")
    kw = dict(kernel_format="scs", chunk_size=8, sigma=4, value_type="dp",
              n_shards=4, seg_method=seg, mode="s")
    op = DistributedSpmvOperator.from_mtx(Config(backend="cpu", **kw), tm)
    jop = JDistributed.from_mtx(JConfig(backend="cpu", use_pallas=False, **kw),
                                jm)
    x0 = np.random.default_rng(2).standard_normal(tm.n_rows)
    assert op.solve_impl_name(4) == "loop"
    prev, y = op.solve(op.make_x(x0), 4)
    jprev, jy = jop.solve(jop.make_x(x0), 4)
    rep = validate_solve(tm, x0, op.to_host(y), 4)
    assert rep.flag == "OK", rep.summary()
    assert rel(op.to_host(y), np.asarray(jop.to_host(jy))) <= 1e-12
    assert rel(op.to_host(prev), np.asarray(jop.to_host(jprev))) <= 1e-12


def test_lane_path_in_interpret_mode_matches():
    """The one case against the JAX lane-tile path (its Pallas kernel in
    interpret mode inside shard_map), with the overlap split."""
    jm, tm = jgen.laplace3d(8), tgen.laplace3d(8)
    kw = dict(kernel_format="scs", chunk_size=1024, sigma=1, value_type="sp",
              n_shards=4, seg_method="seg-nnz")
    jop = JDistributed.from_mtx(JConfig(backend="cpu", use_pallas=True, **kw),
                                jm)
    op = DistributedSpmvOperator.from_mtx(Config(backend="cpu", **kw), tm)
    x = np.random.default_rng(4).standard_normal(tm.n_rows)
    jy = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    y = op.to_host(op.spmv(op.make_x(x)))
    assert rel(y, jy) <= 1e-5
    assert rel(y, tm.to_scipy().tocsr() @ x) <= 1e-5
    assert op.comm_volume_per_spmv() == jop.comm_volume_per_spmv()


def test_spmv_checks_its_vectors():
    _, tm = both("laplace2d(16)")
    op = DistributedSpmvOperator.from_mtx(Config(
        backend="cpu", kernel_format="scs", chunk_size=4, value_type="dp",
        n_shards=4), tm)
    x = op.make_x()
    with pytest.raises(ValueError, match="make_x"):
        op.spmv(x[:, :-1])
    with pytest.raises(ValueError, match="make_x"):
        op.spmv(x.float())
    with pytest.raises(ValueError, match="must not be x"):
        op.spmv(x, out=x)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        op.solve(x, 3, impl="graph")
    with pytest.raises(ValueError, match="fused"):
        op.solve(x, 3, impl="fused")
    out = torch.full_like(x, 7.0)
    y = op.spmv(x, out=out)
    assert y is out
    np.testing.assert_allclose(op.to_host(y), tm.to_scipy() @ op.to_host(x),
                               rtol=1e-12)


def test_bench_results_carry_the_comm_volume():
    _, tm = both("laplace2d(16)")
    op = DistributedSpmvOperator.from_mtx(Config(
        backend="cpu", kernel_format="scs", chunk_size=4, value_type="sp",
        n_shards=4, print_comm_vol=True, bench_time=0.01), tm)
    res = bench_spmv(op, warmup=1, start_iters=1, timing_reps=1)
    comm = op.comm_volume_per_spmv()["sp"]
    assert res.comm_volume_elems == comm["real"] > 0
    assert [s["halo_elems_recv"] for s in res.per_shard] == comm["per_shard"]
    assert sum(s["nnz"] for s in res.per_shard) == tm.nnz
    assert res.comm_volume_per_host == {"sp": {0: comm["real"]}}
    assert res.impl == "torch-plain-dist4-scs-sp"
    text = format_bench_block(op.config, res)
    assert f"comm volume: {comm['real']} halo elems/SpMV" in text
    assert "shard 3: nnz=" in text
    res = bench_solve(op, 3, warmup=1, timing_reps=1)
    assert res.impl == "solve-loop[torch-plain-dist4-scs-sp]"
    assert res.comm_volume_elems == comm["real"]


def test_cli_runs_sharded_solve_and_bench(tmp_path, capsys):
    base = ["Laplace2D,24", "scs", "-c", "8", "-n_shards", "4", "-backend",
            "cpu", "-mtx_out", str(tmp_path)]
    assert cli.main(base + ["-sp", "-mode", "s", "-rev", "3",
                            "-validate", "1"]) == 0
    out = capsys.readouterr().out
    assert "OK" in out and "solve-loop[torch-plain-dist4-scs-sp]" in out
    assert cli.main(base + ["-dp", "-mode", "b", "-bench_time", "0.01",
                            "-print_comm_vol", "1", "-seg_method",
                            "seg-metis", "-comm_mode", "graphtopo"]) == 0
    out = capsys.readouterr().out
    assert "comm volume:" in out and "shard 0: nnz=" in out
    assert "graphtopo" in out


def test_sharded_configs_are_no_longer_refused(monkeypatch):
    cfg = Config(backend="cpu", n_shards=4)
    assert top.uses_kernels(cfg)
    _, tm = both("laplace2d(16)")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(top.DeviceUnavailableError):
        DistributedSpmvOperator.from_mtx(
            Config(backend="cuda", kernel_format="scs", chunk_size=4,
                   value_type="sp", n_shards=4), tm)
    assert cli.main(["Laplace2D,8", "scs", "-n_shards", "4", "-mode", "b",
                     "-backend", "cuda"]) == 3
