"""Heavy-row splitting in uspmv_tpu_torch against the JAX package, on the CPU.

``split_heavy_rows`` must give the JAX function's arrays bit for bit. The
operator then stores the real rows (clamped to the threshold) as
SELL-C-sigma and the virtual rows as a CSR stream of pieces
(``DevicePieces``) that ``ops.scs_pieces`` folds into their parents; the JAX
operator sorts its virtual rows into the SCS and folds them afterwards, so
with the split on the two are compared through ``to_host`` only. On the CPU
the port runs its plain PyTorch versions; the JAX package runs its Pallas
kernels in interpret mode. The CUDA kernels themselves are checked on the
card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances, max|y - ref| / max|ref|: the reference's 1e-13 (dp), 1e-5 (sp)
and 1e-2 (hp, bf16 values against the f64 matrix) times
sqrt(longest row / 32), since a split reorders the sums of a long row.
``mixed_tiles=True`` is covered by tests/test_torch_packed.py.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats.coo import MtxData as JMtxData
from uspmv_tpu.formats.coo import split_heavy_rows as j_split
from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.coo import MtxData, split_heavy_rows
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.device_format import (
    DevicePacked,
    build_device_pieces,
    group_table,
)
from uspmv_tpu_torch.ops.scs_pieces import spmv_pieces
from uspmv_tpu_torch.runtime.bench import bench_spmv
from uspmv_tpu_torch.runtime.operator import SpmvOperator, split_threshold
from uspmv_tpu_torch.runtime.report import format_bench_block

CPU = torch.device("cpu")
BASE_TOL = {"dp": 1e-13, "sp": 1e-5, "hp": 1e-2}


def hand_made(cls):
    """Rows of 0, 1, 5 and 70 elements, an empty last row, unsorted
    columns within rows."""
    rng = np.random.default_rng(4)
    I = np.concatenate([[1], np.full(5, 2), np.full(70, 4), [5]])
    J = np.concatenate([[3], rng.permutation(80)[:5], rng.permutation(80)[:70],
                        [0]])
    return cls.from_arrays(I, J, rng.standard_normal(I.size), n_rows=7,
                           n_cols=80, is_sorted=True)


MATRICES = {
    "random_imbalanced(2000,8)": lambda g, cls: g.random_imbalanced(2000, 8),
    "banded_imbalanced(3000,64,8)": lambda g, cls: g.banded_imbalanced(
        3000, bandwidth=64, avg_nnz_per_row=8, seed=7),
    "hand_made": lambda g, cls: hand_made(cls),
}


def both(name):
    return MATRICES[name](jgen, JMtxData), MATRICES[name](tgen, MtxData)


def tol_for(value_type, mtx):
    longest = int(np.bincount(mtx.I, minlength=mtx.n_rows).max())
    return BASE_TOL[value_type] * max(longest / 32, 1.0) ** 0.5


def rel_err(a, b):
    return np.abs(np.asarray(a, dtype=np.float64) - b).max() / np.abs(b).max()


# ------------------------------------------------------- split_heavy_rows


@pytest.mark.parametrize("threshold", [2, 8, 32])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_split_heavy_rows_bit_equal_to_jax(name, threshold):
    jm, tm = both(name)
    j_out, j_parent = j_split(jm, threshold)
    t_out, t_parent = split_heavy_rows(tm, threshold)
    assert j_parent is not None and t_parent is not None
    assert t_parent.dtype == j_parent.dtype
    assert np.array_equal(t_parent, j_parent)
    assert (t_out.n_rows, t_out.n_cols, t_out.nnz, t_out.is_sorted) == (
        j_out.n_rows, j_out.n_cols, j_out.nnz, j_out.is_sorted)
    for f in ("I", "J", "values"):
        a, b = getattr(t_out, f), getattr(j_out, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.bincount(t_out.I).max() <= threshold


def test_split_heavy_rows_nothing_to_split_and_unsorted():
    tm = tgen.tridiag(50)
    same, parent = split_heavy_rows(tm, 3)
    assert same is tm and parent is None
    with pytest.raises(ValueError, match="row-sorted"):
        split_heavy_rows(dataclasses.replace(tm, is_sorted=False), 2)


@pytest.mark.parametrize("given,C,want", [
    (16, 32, 16), (5000, 32, 5000), (-1, 32, 0), (16, 1, 0), (0, 1, 0),
    (0, 32, 32),  # mean row length 7: min(max(4 * 7, 32), 1024)
])
def test_split_threshold_rule(given, C, want):
    mtx = tgen.random_imbalanced(2000, 8)
    assert mtx.nnz // mtx.n_rows == 7
    cfg = Config(split_rows_threshold=given, backend="cpu")
    assert split_threshold(cfg, mtx, C) == want


def test_split_threshold_auto_follows_the_mean():
    cfg = Config(backend="cpu")
    n = 300
    I, J = np.divmod(np.arange(n * n), n)  # dense: mean row length 300
    dense = MtxData.from_arrays(I, J, np.ones(n * n), n, n, is_sorted=True)
    assert split_threshold(cfg, dense, 32) == 1024
    mid = tgen.random_banded(2000, 100, 40)
    mean = mid.nnz // mid.n_rows
    assert 8 < mean < 256 and split_threshold(cfg, mid, 32) == 4 * mean


# ------------------------------------------------------------ DevicePieces


def decode(op):
    """The (row, column, value) triples an operator stores, in original
    indices, sorted: the SELL-C-sigma or packed real rows plus the pieces."""
    trip = []
    for p, scs in op.scs.items():
        n2o = scs.new_to_old_idx
        dev = op.devs[p]
        if isinstance(dev, DevicePacked):
            rows, cols = dev.row_idxs.numpy(), dev.col_idxs.numpy()
            vals = dev.values.double().numpy()
        else:
            # element j of a row is stored iff j < the row's count
            flat = scs.flat_row_idx()
            j = (np.arange(scs.n_elements) - np.repeat(
                scs.chunk_ptrs[:-1], scs.chunk_lengths.astype(np.int64)
                * scs.C)) // scs.C
            keep = j < scs.row_counts_new[flat]
            rows, cols, vals = flat[keep], scs.col_idxs[keep], scs.values[keep]
        trip.append((n2o[rows], n2o[cols], np.asarray(vals, np.float64)))
        if p in op.pieces:
            pc = op.pieces[p]
            rows = pc.piece_rows.numpy()[pc.piece_idxs.numpy()]
            trip.append((n2o[rows], n2o[pc.col_idxs.numpy()],
                         pc.values.double().numpy()))
    I, J, V = (np.concatenate(t) for t in zip(*trip))
    order = np.lexsort((J, I))
    return I[order], J[order], V[order]


@pytest.mark.parametrize("C,sigma", [(32, 1), (32, 64), (1024, 1)])
@pytest.mark.parametrize("threshold", [2, 8, 32])
@pytest.mark.parametrize("name", ["random_imbalanced(2000,8)",
                                  "banded_imbalanced(3000,64,8)"])
def test_pieces_and_real_rows_decode_to_the_coo(name, threshold, C, sigma):
    _, tm = both(name)
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=C, sigma=sigma,
               value_type="dp", backend="cpu", mixed_tiles=False,
               split_rows_threshold=threshold), tm)
    assert op.split_threshold == threshold and op.n_pieces() > 0
    (pc,) = op.pieces.values()
    counts = np.bincount(tm.I, minlength=tm.n_rows)
    assert pc.n_pieces == int(np.maximum(-(-counts // threshold) - 1, 0).sum())
    assert pc.n_parents == int((counts > threshold).sum())
    assert pc.nnz == int(np.maximum(counts - threshold, 0).sum())
    assert int(op.scs["dp"].row_counts_new.max()) == threshold
    # each parent once, its run of pieces consecutive
    assert np.unique(pc.parent_row.numpy()).size == pc.n_parents
    ptr = pc.parent_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == pc.n_pieces and (np.diff(ptr) > 0).all()
    assert np.array_equal(np.repeat(pc.parent_row.numpy(), np.diff(ptr)),
                          pc.piece_rows.numpy())
    assert int(np.diff(pc.piece_ptr.numpy()).max()) <= threshold
    I, J, V = decode(op)
    order = np.lexsort((tm.J, tm.I))
    assert np.array_equal(I, tm.I[order]) and np.array_equal(J, tm.J[order])
    assert np.array_equal(V, tm.values[order])
    assert sum(op.nnz_per_precision().values()) == tm.nnz
    assert op.nnz_in_pieces() == pc.nnz


def test_build_device_pieces_rejects_scattered_parents():
    with pytest.raises(ValueError, match="consecutive"):
        build_device_pieces(np.array([0, 1, 2]), np.zeros(3, np.int32),
                            np.ones(3), np.array([4, 5, 4]), 8, CPU)
    with pytest.raises(ValueError, match="outside"):
        build_device_pieces(np.array([0]), np.zeros(1, np.int32), np.ones(1),
                            np.array([9]), 8, CPU)


def test_pieces_wrapper_checks_its_arguments():
    pc = build_device_pieces(np.array([0, 0, 1]), np.array([1, 2, 3], np.int32),
                             np.ones(3), np.array([4, 4]), 8, CPU, n_vec=1)
    x = torch.arange(8, dtype=torch.float64)
    y = torch.zeros(8, dtype=torch.float64)
    assert spmv_pieces(pc, x, "rowwise", y) is y
    assert y[4].item() == 6.0 and y.sum().item() == 6.0
    with pytest.raises(TypeError, match="no pieces kernel"):
        spmv_pieces(pc, x.float(), "rowwise", y.float())
    with pytest.raises(ValueError, match="must be"):
        spmv_pieces(pc, x, "rowwise", torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="must not be x"):
        spmv_pieces(pc, x, "rowwise", x)


# ------------------------------------- the pieces against the TPU kernels


def test_pieces_match_the_product_tile_kernels():
    """The virtual rows through the JAX package's transpose-stream tier
    (``_kernel_products_t`` / ``_kernel_products`` in interpret mode, then
    its own reduction), summed per parent, against ``spmv_pieces`` on the
    same split matrix."""
    from uspmv_tpu.runtime.tstream import build_tstream, spmv_tstream

    jm, tm = both("random_imbalanced(2000,8)")
    th = 32
    j_out, parent = j_split(jm, th)
    jscs = j_convert(j_out.astype(np.float32), 1024, 1, native=False)
    assert np.array_equal(jscs.old_to_new_idx, np.arange(j_out.n_rows))
    x = np.zeros(jscs.n_rows_padded, np.float32)
    x[: jm.n_rows] = np.random.default_rng(3).standard_normal(jm.n_rows)
    y_jax = np.asarray(spmv_tstream(build_tstream(jscs), x, interpret=True))
    want = np.zeros(jm.n_rows)
    np.add.at(want, parent, y_jax[jm.n_rows: j_out.n_rows].astype(np.float64))

    t_out, t_parent = split_heavy_rows(tm, th)
    cut = int(np.searchsorted(t_out.I, tm.n_rows))
    pc = build_device_pieces(
        t_out.I[cut:].astype(np.int64) - tm.n_rows, t_out.J[cut:],
        t_out.values[cut:].astype(np.float32), t_parent, tm.n_rows, CPU)
    y = torch.zeros(tm.n_rows, dtype=torch.float32)
    spmv_pieces(pc, torch.from_numpy(x[: tm.n_rows]), "rowwise", y)
    longest = int(np.bincount(tm.I).max())
    assert rel_err(y.numpy(), want) <= 1e-5 * (longest / 32) ** 0.5


# -------------------------------------------- the operator, tier by tier


@pytest.fixture(scope="module")
def matrix():
    jm, tm = both("random_imbalanced(2000,8)")
    x = np.random.default_rng(0).standard_normal(tm.n_rows)
    return jm, tm, x, tm.to_scipy().tocsr() @ x


def configs(C, sigma, value_type, **fields):
    kw = dict(kernel_format="scs", chunk_size=C, sigma=sigma,
              value_type=value_type, backend="cpu", **fields)
    return JConfig(**kw), Config(**kw)


def quiet(cls, cfg, mtx):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the SCS-explosion guard's warning
        return cls.from_mtx(cfg, mtx)


@pytest.mark.parametrize("value_type", ["sp", "dp", "hp"])
@pytest.mark.parametrize("C,sigma", [(32, 1), (32, 64), (1024, 1)])
@pytest.mark.parametrize("mixed_tiles", [None, False])
@pytest.mark.parametrize("threshold", [-1, 0, 16])
def test_operator_matches_jax_operator_and_scipy(matrix, threshold,
                                                 mixed_tiles, C, sigma,
                                                 value_type):
    jm, tm, x, ref = matrix
    jcfg, cfg = configs(C, sigma, value_type, mixed_tiles=mixed_tiles,
                        split_rows_threshold=threshold)
    op = quiet(SpmvOperator, cfg, tm)
    tier = op.impl_name()
    assert ("+pieces" in tier) == (threshold >= 0)
    assert op.split_threshold == {-1: 0, 0: 32, 16: 16}[threshold]
    # the packed tier: forbidden, or chosen by the fill of the clamped rows
    assert ("packed" in tier) == (mixed_tiles is None
                                  and op.beta()[value_type] < 0.5)
    if threshold == 0:  # clamped to 32: beta 0.16 - 0.31 at this size
        assert ("packed" in tier) == (mixed_tiles is None)
    y = op.to_host(op.spmv(op.make_x(x)))
    tol = tol_for(value_type, tm)
    assert rel_err(y, ref) <= tol
    jop = quiet(JOperator, jcfg, jm)
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert y.dtype == y_jax.dtype and y.shape == y_jax.shape
    # hp: both multiply the same bf16 values, so they agree as sp does
    assert rel_err(y, y_jax.astype(np.float64)) <= tol_for(
        "sp" if value_type == "hp" else value_type, tm)


EXTRAS = {
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=0.5),
    "ap[dp_sp]-equilibrate": dict(value_type="ap[dp_sp]", ap_threshold_1=0.5,
                                  equilibrate=True),
    "ap[sp_hp]": dict(value_type="ap[sp_hp]", ap_threshold_1=0.5),
    "dp_emu": dict(value_type="dp", dp_emulation=True),
    "rowwise-4": dict(value_type="sp", block_vec_size=4,
                      vector_layout="rowwise"),
    "colwise-4": dict(value_type="sp", block_vec_size=4,
                      vector_layout="colwise"),
    "colwise-4-packed": dict(value_type="sp", block_vec_size=4,
                             vector_layout="colwise", mixed_tiles=None),
}


@pytest.mark.parametrize("case", sorted(EXTRAS))
def test_split_operator_extras_match_jax_and_scipy(matrix, case):
    """Adaptive precision (each stream with its own pieces), -dp_emu (the
    port splits under it, the JAX operator does not) and block vectors.
    The JAX operator cannot partition an equilibrated matrix whose rows are
    split (its row scales do not cover the virtual rows), so there it runs
    with the split off."""
    jm, tm, x, _ = matrix
    fields = {"mixed_tiles": False, **EXTRAS[case]}
    jcfg, cfg = configs(32, 64, fields.pop("value_type"), **fields)
    if cfg.equilibrate:
        jcfg = dataclasses.replace(jcfg, split_rows_threshold=-1)
    op, jop = quiet(SpmvOperator, cfg, tm), quiet(JOperator, jcfg, jm)
    assert op.n_pieces() > 0 and op.split_threshold == 32
    if cfg.is_ap:
        assert list(op.pieces) == list(cfg.ap_precisions)
    bs = cfg.block_vec_size
    xb = x if bs == 1 else np.stack([x * (i + 1) for i in range(bs)], axis=1)
    y = op.to_host(op.spmv(op.make_x(xb)))
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(xb))), np.float64)
    A = tm.to_scipy().tocsr()
    if cfg.equilibrate:
        from uspmv_tpu_torch.formats.coo import equilibrate_matrix

        m = tm.copy()
        equilibrate_matrix(m)
        A = m.to_scipy().tocsr()
    hp = "hp" in cfg.value_type
    f64 = cfg.working_dtype() == torch.float64
    # ap[dp_sp] holds sp values (rounded to f32) and sums them in f64
    vs_scipy = tol_for("hp" if hp else "sp" if cfg.is_ap or not f64 else "dp",
                       tm)
    assert y.shape == xb.shape and rel_err(y, A @ xb) <= vs_scipy
    # under -dp_emu the JAX package sums (hi, lo) float pairs, which are
    # float-accurate off the TPU
    exact = f64 and not cfg.dp_emulation
    assert rel_err(y, y_jax) <= tol_for("dp" if exact else "sp", tm)


@pytest.mark.parametrize("mixed_tiles", [None, False])
def test_split_solve_matches_jax(matrix, mixed_tiles):
    jm, tm, x, _ = matrix
    scale = 1.0 / np.bincount(tm.I, weights=np.abs(tm.values)).max()
    jm, tm = jm.copy(), tm.copy()
    jm.values[:] = jm.values * scale
    tm.values[:] = tm.values * scale
    jcfg, cfg = configs(32, 64, "sp", mixed_tiles=mixed_tiles)
    op, jop = quiet(SpmvOperator, cfg, tm), quiet(JOperator, jcfg, jm)
    assert op.n_pieces() > 0
    tx, ty = op.solve(op.make_x(x), 5)
    jx, jy = jop.solve(jop.make_x(x), 5)
    A = tm.to_scipy().tocsr()
    ref = x
    for _ in range(5):
        prev, ref = ref, A @ ref
    tol = 5 * tol_for("sp", tm)
    assert rel_err(op.to_host(ty), ref) <= tol
    assert rel_err(op.to_host(tx), prev) <= tol
    assert rel_err(op.to_host(ty), np.asarray(jop.to_host(jy), np.float64)) <= tol
    assert rel_err(op.to_host(tx), np.asarray(jop.to_host(jx), np.float64)) <= tol
    # neither pieces nor packed rows go through the fused solve kernel
    assert not op.fused_solve_eligible()
    assert op.solve_impl_name(5) == "loop"
    with pytest.raises(ValueError, match="fused solve kernel takes"):
        op.solve(op.make_x(x), 5, impl="fused")


# ------------------------------------------- what the split leaves alone


@pytest.mark.parametrize("spec", ["Laplace3D,10", "Tridiag,500", "FemTet3D,4",
                                  "WideSpectrum,4"])
@pytest.mark.parametrize("C,sigma", [(1024, 1), (32, 64)])
def test_balanced_matrices_keep_the_scs_tier_and_arrays(spec, C, sigma):
    """Longest row <= 4 * mean: the automatic threshold splits nothing, and
    the operator is the one built with the split off."""
    tm = tgen.generate_matrix(spec)
    kw = dict(kernel_format="scs", chunk_size=C, sigma=sigma, value_type="sp",
              backend="cpu")
    op = SpmvOperator.from_mtx(Config(**kw), tm)
    off = SpmvOperator.from_mtx(
        Config(split_rows_threshold=-1, mixed_tiles=False, **kw), tm)
    assert not op.pieces and op.n_pieces() == 0
    if op.beta()["sp"] >= 0.5:
        assert op.impl_name() == "torch-plain-scs-sp"
        # the kernel reads the slots below each group's length, counted
        # from the JAX package's SCS of the same matrix
        js = j_convert(jgen.generate_matrix(spec), C, sigma, native=False)
        assert np.array_equal(js.row_counts_new,
                              op.scs["sp"].row_counts_new)
        _, read = group_table(js)
        assert op.device_beta() == off.device_beta() == {"sp": js.nnz / read}
        assert op.bytes_per_spmv() == off.bytes_per_spmv()
    for f in ("chunk_ptrs", "chunk_lengths", "col_idxs", "values",
              "old_to_new_idx"):
        assert np.array_equal(getattr(op.scs["sp"], f),
                              getattr(off.scs["sp"], f)), f


def test_unsplit_arrays_match_jax_with_the_split_off_in_both(matrix):
    jm, tm, _, _ = matrix
    jcfg, cfg = configs(32, 64, "dp", split_rows_threshold=-1,
                        mixed_tiles=False)
    op, jop = quiet(SpmvOperator, cfg, tm), quiet(JOperator, jcfg, jm)
    assert np.array_equal(op.old_to_new, jop.old_to_new[: tm.n_rows])
    for f in ("chunk_ptrs", "chunk_lengths", "col_idxs", "values"):
        assert np.array_equal(getattr(op.scs["dp"], f),
                              getattr(jop.scs["dp"], f)), f


# ---------------------------------------------------- metrics, report, CLI


def test_metrics_and_report_carry_the_pieces(matrix):
    _, tm, _, _ = matrix
    _, cfg = configs(32, 64, "sp", mixed_tiles=False, block_vec_size=2,
                     vector_layout="rowwise")
    op = quiet(SpmvOperator, cfg, tm)
    (scs,), (dev,), (pc,) = op.scs.values(), op.devs.values(), op.pieces.values()
    assert op.impl_name() == "torch-plain-scs+pieces-sp"
    assert op.nnz_per_precision() == {"sp": tm.nnz}
    assert scs.nnz + pc.nnz == tm.nnz and op.beta() == {"sp": scs.beta}
    # the slots the kernel reads, from the JAX package's SCS of the parent
    # rows the JAX split leaves (rows below n_rows, clamped)
    jm = matrix[0]
    j_out, _ = j_split(jm, op.split_threshold)
    cut = int(np.searchsorted(j_out.I, jm.n_rows))
    parents = JMtxData.from_arrays(j_out.I[:cut], j_out.J[:cut],
                                   j_out.values[:cut], jm.n_rows, jm.n_cols)
    _, read = group_table(j_convert(parents, 32, 64, native=False))
    assert dev.n_read == read < scs.n_elements
    assert op.device_beta() == {"sp": tm.nnz / (read + pc.nnz)}
    # per pass of up to 8 vectors: the pieces' stream, the parents' runs
    # and rows and the work records once, and each long parent's entry and
    # counter (read and written); per vector: each long record's slot (an
    # 8 B word per float sum: written, read and cleared)
    n_rec, n_long = pc.records.shape[0], pc.longs.shape[0]
    long_records = int((pc.records[:, 3] >= 0).sum())
    assert 0 < long_records < n_rec
    assert pc.pass_bytes() == 4 * (2 * pc.nnz + pc.n_pieces + 1
                                   + 2 * pc.n_parents + 1 + 4 * n_rec
                                   + 6 * n_long)
    assert pc.vector_bytes() == 4 * 6 * long_records
    assert pc.stream_bytes() == pc.pass_bytes() + pc.vector_bytes()
    assert op.bytes_per_spmv() == (dev.stream_bytes() + pc.pass_bytes()
                                   + 2 * pc.vector_bytes()
                                   + 2 * 2 * 4 * op.n_rows_padded)
    res = bench_spmv(op, bench_time=1e-3, warmup=1, start_iters=2,
                     timing_reps=2)
    assert (res.split_rows_threshold, res.n_pieces, res.nnz_in_pieces) == (
        32, pc.n_pieces, pc.nnz)
    text = format_bench_block(cfg, res)
    assert "impl: torch-plain-scs+pieces-sp" in text
    assert (f"split_rows_threshold=32 pieces={pc.n_pieces} "
            f"nnz_in_pieces={pc.nnz}") in text


@pytest.mark.parametrize("flags,tier", [
    (["-split_rows_threshold", "16", "-mixed_tiles", "1"], "packed+pieces"),
    (["-split_rows_threshold", "16", "-mixed_tiles", "0"], "scs+pieces"),
    (["-split_rows_threshold", "-1", "-mixed_tiles", "1"], "packed"),
    (["-split_rows_threshold", "-1", "-mixed_tiles", "0"], "scs"),
    ([], "packed+pieces"),
])
def test_cli_flags_choose_the_tier(tmp_path, capsys, flags, tier):
    rc = cli.main(["RandomImbalanced,2000,8", "scs", "-c", "32", "-s", "64",
                   "-sp", "-backend", "cpu", "-mode", "s", "-rev", "1",
                   "-mtx_out", str(tmp_path), *flags])
    text = (tmp_path / "spmv_scipy_compare_sp.txt").read_text()
    assert f"impl: solve-loop[torch-plain-{tier}-sp]" in text
    assert rc == 0 and "[OK]" in capsys.readouterr().out
