"""The padding-free packed-row tier of uspmv_tpu_torch against the JAX
package, on the CPU.

``DevicePacked`` is an ``ScsData`` with its padding dropped, cut into row
groups; ``spmv_packed`` (its plain PyTorch version here) must agree with the
TPU mixed-tile kernel ``spmv_mixed_tiles`` (Pallas interpret mode) on the
very same SCS arrays, and the operator with ``mixed_tiles=True`` with the JAX
operator and scipy. The CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerances, max|y - ref| / max|ref|: the reference's 1e-13 (dp), 1e-5 (sp)
and 1e-2 (hp, bf16 values against the f64 matrix) times
sqrt(longest row / 32) where sums are reordered. On the CPU the packed and
the SELL-C-sigma plain versions add a row's products in the same order (j
ascending), so they agree bit for bit.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats.coo import split_heavy_rows as j_split
from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.ops.pallas_scs import build_device_mixed_tiles, spmv_mixed_tiles
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.coo import MtxData
from uspmv_tpu_torch.formats.scs import (
    convert_to_scs,
    permute_scs_cols,
    scs_from_reference,
)
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops import scs_packed
from uspmv_tpu_torch.ops.device_format import (
    GROUP_MAX_ELEMS,
    GROUP_MAX_ROWS,
    build_device_packed,
    build_device_scs,
    row_groups,
)
from uspmv_tpu_torch.ops.scs_packed import spmv_packed, spmv_packed_plain
from uspmv_tpu_torch.ops.scs_spmv import spmv_scs_plain
from uspmv_tpu_torch.runtime.operator import PACKED_BETA_CUTOFF, SpmvOperator

CPU = torch.device("cpu")
BASE_TOL = {"dp": 1e-13, "sp": 1e-5, "hp": 1e-2}


def with_empty_rows():
    """Rows 0, 5, 6 and the last 300 rows empty; one row much longer."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.repeat(np.arange(1, 5), 3),
                           np.repeat(np.arange(7, 90), 2), np.full(40, 50)])
    cols = rng.integers(0, 400, rows.size)
    _, first = np.unique(rows * 400 + cols, return_index=True)
    return MtxData.from_arrays(rows[first], cols[first],
                               rng.standard_normal(first.size),
                               n_rows=400, n_cols=400).sort_by_row()


MATRICES = {
    "random_imbalanced(2000,8)": lambda: tgen.random_imbalanced(2000, 8),
    "banded_imbalanced(3000,64,8)": lambda: tgen.banded_imbalanced(
        3000, bandwidth=64, avg_nnz_per_row=8, seed=7),
    "powerlaw_cols(2000,8)": lambda: tgen.powerlaw_cols(2000, 8),
    "with_empty_rows": with_empty_rows,
}


def permuted_scs(mtx, C, sigma):
    scs = convert_to_scs(mtx, C, sigma)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, perm)
    return scs


def rel_err(a, b):
    return np.abs(np.asarray(a, dtype=np.float64) - b).max() / np.abs(b).max()


def tol_for(value_type, mtx):
    longest = int(np.bincount(mtx.I, minlength=mtx.n_rows).max())
    return BASE_TOL[value_type] * max(longest / 32, 1.0) ** 0.5


# ------------------------------------------------------------ DevicePacked


@pytest.mark.parametrize("C,sigma", [(1, 1), (32, 1), (32, 64), (1024, 1),
                                     (7, 4)])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_packed_decodes_to_the_coo(name, C, sigma):
    mtx = MATRICES[name]()
    scs = convert_to_scs(mtx, C, sigma)  # columns left in original order
    dev = build_device_packed(scs, CPU)
    assert dev.nnz == mtx.nnz and dev.device_beta == 1.0
    assert dev.n_rows_padded == scs.n_rows_padded
    row_ptr, groups = dev.row_ptr.numpy(), dev.group_ptr.numpy()
    assert np.array_equal(np.diff(row_ptr), scs.row_counts_new)
    assert np.array_equal(np.repeat(np.arange(scs.n_rows_padded),
                                    np.diff(row_ptr)), dev.row_idxs.numpy())
    # the groups cover every padded row, within the kernel's limits
    assert groups[0] == 0 and groups[-1] == scs.n_rows_padded
    assert (np.diff(groups) > 0).all() and dev.n_groups == groups.size - 1
    assert np.diff(groups).max() <= GROUP_MAX_ROWS
    assert np.diff(row_ptr[groups]).max() <= GROUP_MAX_ELEMS
    assert dev.stream_bytes() == (8 + 4) * mtx.nnz + 4 * (row_ptr.size
                                                          + groups.size)
    # the stored triples, in original indices
    I = scs.new_to_old_idx[dev.row_idxs.numpy()]
    J, V = dev.col_idxs.numpy(), dev.values.numpy()
    order, want = np.lexsort((J, I)), np.lexsort((mtx.J, mtx.I))
    assert np.array_equal(I[order], mtx.I[want])
    assert np.array_equal(J[order], mtx.J[want])
    assert np.array_equal(V[order], mtx.values[want])
    # within a row, the SCS's own order (the input order of the COO)
    row7 = I == mtx.I[mtx.nnz // 2]
    assert np.array_equal(J[row7], mtx.J[mtx.I == mtx.I[mtx.nnz // 2]])


def greedy_groups(row_ptr, max_rows, max_elems):
    """The same cuts by a loop over rows."""
    cuts, start = [0], 0
    for r in range(1, row_ptr.size):
        if r - start > max_rows or row_ptr[r] - row_ptr[start] > max_elems:
            cuts.append(r - 1)
            start = r - 1
    cuts.append(row_ptr.size - 1)
    return np.asarray(cuts)


@pytest.mark.parametrize("max_rows,max_elems", [(256, 4096), (8, 64),
                                                (3, 10**6), (10**6, 70)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_groups_are_the_greedy_cuts(seed, max_rows, max_elems):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, 700) * (rng.random(700) < 0.6)
    counts[rng.integers(0, 700, 5)] = 64  # rows that nearly fill a group
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    got = row_groups(row_ptr, max_rows, max_elems)
    assert got.dtype == np.int32
    assert np.array_equal(got, greedy_groups(row_ptr, max_rows, max_elems))


def test_row_groups_edge_cases():
    assert np.array_equal(row_groups(np.zeros(1, np.int64)), [0])
    assert np.array_equal(row_groups(np.zeros(601, np.int64)),
                          [0, 256, 512, 600])  # nothing but empty rows
    with pytest.raises(ValueError, match="split_rows_threshold"):
        row_groups(np.array([0, 3, 3 + GROUP_MAX_ELEMS + 1]))
    assert np.array_equal(row_groups(np.array([0, 3, 3 + GROUP_MAX_ELEMS])),
                          [0, 1, 2])


def test_a_row_too_long_to_stage_names_the_split(monkeypatch):
    n = GROUP_MAX_ELEMS + 100
    I = np.concatenate([np.zeros(n, np.int64), np.arange(1, 50)])
    J = np.concatenate([np.arange(n), np.arange(1, 50)])
    mtx = MtxData.from_arrays(I, J, np.ones(I.size), n, n, is_sorted=True)
    kw = dict(kernel_format="scs", chunk_size=32, sigma=1, value_type="sp",
              backend="cpu")
    with pytest.raises(ValueError, match="split_rows_threshold"):
        SpmvOperator.from_mtx(
            Config(mixed_tiles=True, split_rows_threshold=-1, **kw), mtx)
    # left to itself the operator does not pick a tier that cannot be built
    op = SpmvOperator.from_mtx(Config(split_rows_threshold=-1, **kw), mtx)
    assert op.beta()["sp"] < PACKED_BETA_CUTOFF
    assert op.impl_name() == "torch-plain-scs-sp"
    op = SpmvOperator.from_mtx(Config(mixed_tiles=True, **kw), mtx)
    assert op.impl_name() == "torch-plain-packed+pieces-sp"
    x = np.arange(1.0, n + 1)
    assert rel_err(op.to_host(op.spmv(op.make_x(x))),
                   mtx.to_scipy().tocsr() @ x) <= 1e-5


# --------------------------------------------- the wrapper, plain version

PAIRS = sorted(scs_packed._ENTRY_POINTS, key=str)
SHAPES = [("rowwise", 1), ("rowwise", 4), ("rowwise", 11), ("colwise", 4)]


@pytest.mark.parametrize("form", ["new", "accumulate", "out"])
@pytest.mark.parametrize("layout,bs", SHAPES)
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_packed_equals_scs_plain_bit_for_bit(pair, layout, bs, form):
    vdt, xdt = pair
    scs = permuted_scs(MATRICES["random_imbalanced(2000,8)"](), 32, 64)
    scs.values = torch.from_numpy(scs.values).to(vdt).double().numpy()
    packed = build_device_packed(scs, CPU, vdt)
    sell = build_device_scs(scs, CPU, vdt)
    n = scs.n_rows_padded
    shape = (n,) if bs == 1 else (n, bs) if layout == "rowwise" else (bs, n)
    gen = torch.Generator().manual_seed(bs)
    x = torch.randn(shape, generator=gen, dtype=torch.float64).to(xdt)
    y0 = torch.randn(shape, generator=gen, dtype=torch.float64).to(xdt)
    want = spmv_scs_plain(sell, x, layout,
                          y0.clone() if form == "accumulate" else None)
    if form == "new":
        y = spmv_packed(packed, x, layout)
    elif form == "accumulate":
        y = y0.clone()
        assert spmv_packed(packed, x, layout, y) is y
    else:
        y = y0.clone()
        assert spmv_packed(packed, x, layout, out=y) is y
    assert y.dtype == xdt and tuple(y.shape) == shape
    assert torch.equal(y, want)
    assert scs_packed.launch_count() == 0  # no kernel for a CPU tensor


def test_packed_wrapper_checks_its_arguments():
    scs = permuted_scs(tgen.tridiag(40), 8, 1)
    dev = build_device_packed(scs, CPU)
    x = torch.ones(40, dtype=torch.float64)
    with pytest.raises(TypeError, match="no packed-row kernel"):
        spmv_packed(dev, x.float())
    with pytest.raises(TypeError, match="no packed-row kernel"):
        # (f32, f64) is an adaptive-precision pair: SELL-C-sigma only
        spmv_packed(build_device_packed(scs, CPU, torch.float32), x)
    with pytest.raises(ValueError, match="at least"):
        spmv_packed(dev, x[:10])
    with pytest.raises(ValueError, match="not both"):
        spmv_packed(dev, x, y=x.clone(), out=x.clone())
    with pytest.raises(ValueError, match="must not be x"):
        spmv_packed(dev, x, out=x)
    with pytest.raises(ValueError, match="layout"):
        spmv_packed(dev, x, "diagonal")
    assert scs_packed.entry_point(torch.bfloat16, torch.float32) \
        == "uspmv_scs_packed_bf16_f32"


# ------------------------------------- against the TPU mixed-tile kernel


@pytest.mark.parametrize("bs", [1, 2])
def test_packed_matches_the_mixed_tile_kernel(bs):
    """``spmv_mixed_tiles`` (Pallas interpret mode) and ``spmv_packed`` on
    the same SCS arrays: random_imbalanced split at 32, C=1024, sigma=1, as
    the JAX package's own test of the kernel builds them."""
    jm, _ = j_split(jgen.random_imbalanced(4000, 8, seed=3), 32)
    jscs = j_convert(jm.astype(np.float32), 1024, 1, native=False)
    x = np.random.default_rng(0).standard_normal(
        (jscs.n_rows_padded, bs)).astype(np.float32)
    x = x[:, 0] if bs == 1 else x
    jdev = build_device_mixed_tiles(jscs, window_rows=32, block_vec_size=bs)
    y_jax = np.asarray(spmv_mixed_tiles(jdev, jnp.asarray(x), interpret=True))
    dev = build_device_packed(scs_from_reference(dataclasses.asdict(jscs)),
                              CPU)
    y = spmv_packed(dev, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert rel_err(y.numpy(), y_jax.astype(np.float64)) <= 1e-5
    assert rel_err(y.numpy(), jscs.spmv_reference(x)) <= 1e-5


# ------------------------------------------- the operator, mixed_tiles=True


@pytest.fixture(scope="module")
def matrix():
    jm, tm = jgen.random_imbalanced(2000, 8), tgen.random_imbalanced(2000, 8)
    x = np.random.default_rng(0).standard_normal(tm.n_rows)
    return jm, tm, x, tm.to_scipy().tocsr() @ x


def quiet(cls, cfg, mtx):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the SCS-explosion guard's warning
        return cls.from_mtx(cfg, mtx)


@pytest.mark.parametrize("value_type", ["sp", "dp", "hp"])
@pytest.mark.parametrize("C,sigma", [(32, 1), (32, 64), (1024, 1)])
@pytest.mark.parametrize("threshold", [-1, 0, 16])
def test_forced_packed_operator_matches_jax_operator_and_scipy(
        matrix, threshold, C, sigma, value_type):
    """With the split on and one f32 vector the JAX operator answers
    ``mixed_tiles=True`` with its transpose-stream tier, ~18 s a case in
    interpret mode: it is the reference at (32, 1), and scipy alone at the
    two other (C, sigma)."""
    jm, tm, x, ref = matrix
    kw = dict(kernel_format="scs", chunk_size=C, sigma=sigma,
              value_type=value_type, backend="cpu", mixed_tiles=True,
              split_rows_threshold=threshold)
    op = quiet(SpmvOperator, Config(**kw), tm)
    pieces = "+pieces" if threshold >= 0 else ""
    assert op.impl_name() == f"torch-plain-packed{pieces}-{value_type}"
    assert op.device_beta() == {value_type: 1.0}
    y = op.to_host(op.spmv(op.make_x(x)))
    assert rel_err(y, ref) <= tol_for(value_type, tm)
    slow = threshold >= 0 and value_type != "dp"
    if slow and (C, sigma) != (32, 1):
        return
    jop = quiet(JOperator, JConfig(**kw), jm)
    assert ("tstream" in jop.impl_name()) == slow
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert y.dtype == y_jax.dtype and y.shape == y_jax.shape
    assert rel_err(y, y_jax.astype(np.float64)) <= tol_for(
        "sp" if value_type == "hp" else value_type, tm)


EXTRAS = {
    "rowwise-4": dict(value_type="sp", block_vec_size=4,
                      vector_layout="rowwise"),
    "colwise-4": dict(value_type="sp", block_vec_size=4,
                      vector_layout="colwise"),
    "dp_emu": dict(value_type="dp", dp_emulation=True),
    "hp-rowwise-2": dict(value_type="hp", block_vec_size=2,
                         vector_layout="rowwise"),
}


@pytest.mark.parametrize("case", sorted(EXTRAS))
def test_packed_operator_extras_match_jax_and_scipy(matrix, case):
    jm, tm, x, _ = matrix
    kw = dict(kernel_format="scs", chunk_size=1024, sigma=1, backend="cpu",
              mixed_tiles=True, **EXTRAS[case])
    op, jop = quiet(SpmvOperator, Config(**kw), tm), \
        quiet(JOperator, JConfig(**kw), jm)
    assert op.is_packed() and op.n_pieces() > 0
    bs = op.config.block_vec_size
    xb = x if bs == 1 else np.stack([x * (i + 1) for i in range(bs)], axis=1)
    y = op.to_host(op.spmv(op.make_x(xb)))
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(xb))), np.float64)
    vt = op.config.value_type
    assert y.shape == xb.shape
    assert rel_err(y, tm.to_scipy().tocsr() @ xb) <= tol_for(vt, tm)
    # under -dp_emu the JAX package sums (hi, lo) float pairs, which are
    # float-accurate off the TPU
    assert rel_err(y, y_jax) <= tol_for(
        "sp" if vt == "hp" or op.config.dp_emulation else vt, tm)


def test_adaptive_precision_keeps_sell_c_sigma(matrix):
    """As in the JAX operator, the adaptive streams do not take the packed
    tier, forced or not."""
    _, tm, x, ref = matrix
    for mixed in (True, None):
        op = quiet(SpmvOperator, Config(
            kernel_format="scs", chunk_size=1024, sigma=1, backend="cpu",
            value_type="ap[dp_sp]", ap_threshold_1=0.5, mixed_tiles=mixed), tm)
        assert op.impl_name() == "torch-plain-scs+pieces-ap[dp_sp]"
        assert rel_err(op.to_host(op.spmv(op.make_x(x))), ref) <= tol_for(
            "sp", tm)


def test_packed_solve_matches_jax_and_fused_is_refused(matrix):
    jm, tm, x, _ = matrix
    scale = 1.0 / np.bincount(tm.I, weights=np.abs(tm.values)).max()
    jm, tm = jm.copy(), tm.copy()
    jm.values[:] = jm.values * scale
    tm.values[:] = tm.values * scale
    kw = dict(kernel_format="scs", chunk_size=32, sigma=64, value_type="sp",
              backend="cpu", mixed_tiles=True, split_rows_threshold=-1)
    op, jop = quiet(SpmvOperator, Config(**kw), tm), \
        quiet(JOperator, JConfig(**kw), jm)
    assert op.impl_name() == "torch-plain-packed-sp"
    tx, ty = op.solve(op.make_x(x), 5)
    jx, jy = jop.solve(jop.make_x(x), 5)
    tol = 5 * tol_for("sp", tm)
    assert rel_err(op.to_host(ty), np.asarray(jop.to_host(jy), np.float64)) <= tol
    assert rel_err(op.to_host(tx), np.asarray(jop.to_host(jx), np.float64)) <= tol
    assert not op.fused_solve_eligible()
    with pytest.raises(ValueError, match="fused solve kernel takes"):
        op.solve(op.make_x(x), 5, impl="fused")


@pytest.mark.parametrize("spec,C,sigma,packed", [
    ("PowerLawCols,2000,8", 1024, 1, True),    # beta 0.45
    ("PowerLawCols,2000,8", 32, 64, False),    # beta 0.69
    ("BandedImbalanced,3000,64,8", 1024, 1, True),
    ("Laplace3D,10", 1024, 1, False),
    ("Tridiag,500", 32, 1, False),
])
def test_the_operator_packs_below_the_beta_cutoff(spec, C, sigma, packed):
    tm = tgen.generate_matrix(spec)
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=C, sigma=sigma,
               value_type="sp", backend="cpu"), tm)
    assert (op.beta()["sp"] < PACKED_BETA_CUTOFF) == packed
    assert op.is_packed() == packed
    x = np.random.default_rng(1).standard_normal(tm.n_rows)
    assert rel_err(op.to_host(op.spmv(op.make_x(x))),
                   tm.to_scipy().tocsr() @ x) <= 1e-5
