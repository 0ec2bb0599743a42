"""The host build's passes over the nonzeros, on the CPU.

A SELL-C-sigma stream's row index is built on the device at its first read
(``DeviceScs.row_idxs``), equal to ``ScsData.flat_row_idx()`` element for
element, and booked once per stream as ``row_index_builds``. ``from_mtx``
leaves the caller's ``MtxData`` as it was, shares its arrays where nothing
writes into them, counts the rows once, and skips the column gather
through an identity permutation; every device buffer it places is bit-equal
to a build that copies, converts, permutes every column and flattens the
row index on the host.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu_torch.config import Config, dtype_for, host_values
from uspmv_tpu_torch.formats.coo import (
    MtxData,
    extract_matrix_min_mean_max,
    split_heavy_rows,
)
from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.device_format import (
    DevicePacked,
    DeviceScs,
    build_device_packed,
    build_device_pieces,
    build_device_scs,
    group_table,
)
from uspmv_tpu_torch.precision.partition import partition_precisions
from uspmv_tpu_torch.runtime import profiling
from uspmv_tpu_torch.runtime.operator import (
    SpmvOperator,
    guard_scs_explosion,
    real_rows,
    split_threshold,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.reset()


def builds() -> int:
    return profiling.snapshot()["counters"].get(
        profiling.ROW_INDEX_BUILDS, 0)


def shuffled(mtx: MtxData, seed: int = 3) -> MtxData:
    """The same triplets in a random order, marked unsorted."""
    perm = np.random.default_rng(seed).permutation(mtx.nnz)
    return dataclasses.replace(mtx, I=mtx.I[perm], J=mtx.J[perm],
                               values=mtx.values[perm], is_sorted=False)


def op_of(mtx, **kw):
    cfg = Config(**{"kernel_format": "scs", "chunk_size": 32, "sigma": 1,
                    "value_type": "dp", "backend": "cpu", **kw})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return SpmvOperator.from_mtx(cfg, mtx)


# ------------------------------------------------------- the row index


@pytest.mark.parametrize("prec", ["dp", "sp", "hp"])
@pytest.mark.parametrize("C,sigma", [(1, 1), (4, 1), (32, 1), (32, 8),
                                     (16, 64), (7, 3)])
def test_lazy_row_index_is_the_flat_row_index(C, sigma, prec):
    mtx = tgen.random_imbalanced(700, 6)
    scs = convert_to_scs(dataclasses.replace(
        mtx, values=host_values(mtx.values, prec)), C, sigma, native=False)
    dev = build_device_scs(scs, CPU, dtype_for(prec))
    assert dev._row_idxs is None and builds() == 0
    rows = dev.row_idxs
    assert builds() == 1
    assert rows.dtype == torch.int32 and rows.device == CPU
    assert np.array_equal(rows.numpy(), scs.flat_row_idx())
    assert dev.row_idxs is rows and builds() == 1  # kept, built once


def test_lazy_row_index_of_a_unit_stream():
    mtx = tgen.laplace3d(9)
    ones = dataclasses.replace(mtx, values=np.ones(mtx.nnz, np.float32))
    scs = convert_to_scs(ones, 16, 4, native=False)
    dev = build_device_scs(scs, CPU, unit_values=True)
    assert dev.unit_vals and dev._row_idxs is None
    assert np.array_equal(dev.row_idxs.numpy(), scs.flat_row_idx())
    assert builds() == 1


def test_lazy_row_index_of_an_empty_stream():
    empty = MtxData.from_arrays([], [], np.zeros(0), n_rows=0, n_cols=0,
                                is_sorted=True)
    scs = convert_to_scs(empty, 8, 1, native=False)
    dev = build_device_scs(scs, CPU)
    assert dev.row_idxs.numel() == 0 and dev.row_idxs.dtype == torch.int32


@pytest.mark.parametrize("value_type,kw", [
    ("dp", dict(chunk_size=32, sigma=1)),
    ("sp", dict(chunk_size=32, sigma=8)),
    ("hp", dict(chunk_size=16, sigma=1)),
    ("dp", dict(chunk_size=32, sigma=1, split_rows_threshold=16)),
    ("ap[dp_sp]", dict(chunk_size=32, sigma=4, ap_threshold_1=1.5)),
    ("ap[dp_sp_hp]", dict(chunk_size=8, sigma=1, ap_threshold_1=2.0,
                          ap_threshold_2=0.5)),
    ("sp", dict(chunk_size=32, sigma=1, mixed_tiles=True)),
], ids=["dp", "sp-sigma8", "hp", "dp-pieces", "ap2", "ap3", "packed"])
def test_row_index_builds_once_per_stream_at_the_first_plain_spmv(
        value_type, kw):
    op = op_of(tgen.random_imbalanced(2000, 8), value_type=value_type, **kw)
    assert builds() == 0  # the build reads no row index
    sell = [d for d in op.devs.values() if isinstance(d, DeviceScs)]
    assert all(d._row_idxs is None for d in sell)
    x = op.make_x()
    y = op.spmv(x)
    assert builds() == len(sell)  # the plain version reads each once
    op.spmv(x, out=torch.empty_like(y))
    assert builds() == len(sell)
    for p, d in op.devs.items():
        if isinstance(d, DeviceScs):
            assert np.array_equal(d.row_idxs.numpy(),
                                  op.scs[p].flat_row_idx())


# ------------------------------------------- the caller's matrix, shared


CALLER_CASES = {
    "dp": dict(),
    "sp": dict(value_type="sp"),
    "hp": dict(value_type="hp"),
    "jacobi": dict(jacobi_scale=True),
    "equilibrate": dict(equilibrate=True),
    "unsorted": dict(unsorted=True),
    "split": dict(split_rows_threshold=8),
    "split-equilibrate": dict(split_rows_threshold=8, equilibrate=True),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=1.5),
    "ap[dp_sp]-equilibrate": dict(value_type="ap[dp_sp]", ap_threshold_1=0.5,
                                  equilibrate=True),
    "crs": dict(kernel_format="crs", chunk_size=1, sigma=1,
                jacobi_scale=True),
}


@pytest.mark.parametrize("case", list(CALLER_CASES))
def test_from_mtx_leaves_the_callers_matrix_as_it_was(case):
    kw = dict(CALLER_CASES[case])
    mtx = tgen.fem_tet3d(6)
    if kw.pop("unsorted", False):
        mtx = shuffled(mtx)
    attrs = dict(vars(mtx))
    arrays = {k: v.copy() for k, v in attrs.items()
              if isinstance(v, np.ndarray)}
    op = op_of(mtx, **{"sigma": 4, **kw})
    assert vars(mtx).keys() == attrs.keys()
    for k, v in vars(mtx).items():
        assert v is attrs[k], k  # no attribute rebound
        if k in arrays:
            assert v.dtype == arrays[k].dtype
            assert np.array_equal(v, arrays[k]), k
    y = op.to_host(op.spmv(op.make_x(np.ones(mtx.n_cols))))
    assert np.isfinite(y).all()


def test_dp_values_reach_the_converter_without_a_copy():
    mtx = tgen.laplace3d(6)
    assert host_values(mtx.values, "dp") is mtx.values
    sp = host_values(mtx.values, "sp")
    assert host_values(sp, "sp") is sp
    assert host_values(sp, "hp") is not sp  # rounded to bf16: a new array


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 3])
def test_matrix_stats_by_blocks_equal_one_abs_in_float64(dtype, n):
    rng = np.random.default_rng(n)
    vals = (rng.standard_normal(n) * 100).astype(dtype)
    mtx = MtxData.from_arrays(np.arange(n) % 7, np.zeros(n), vals, n_rows=7,
                              n_cols=1)
    a = np.abs(vals.astype(np.float64))
    mn = float(a.min()) if n else 0.0
    mx = float(a.max()) if n else 0.0
    assert extract_matrix_min_mean_max(mtx) == (mn, mn + (mx - mn) / 2.0, mx)


def test_matrix_stats_keep_a_nan():
    vals = np.ones((1 << 20) + 5)
    vals[-1] = np.nan
    mtx = MtxData.from_arrays(np.zeros(vals.size), np.zeros(vals.size), vals)
    mn, _, mx = extract_matrix_min_mean_max(mtx)
    assert np.isnan(mn) and np.isnan(mx)


# --------------------------------------------------- rows counted once


@pytest.mark.parametrize("case", ["sorted", "unsorted", "empty-rows",
                                  "empty"])
def test_row_counts_are_numpys_bincount(case):
    mtx = tgen.random_imbalanced(1500, 8)
    if case == "unsorted":
        mtx = shuffled(mtx)
    elif case == "empty-rows":  # rows beyond the last nonzero hold none
        mtx = dataclasses.replace(mtx, n_rows=mtx.n_rows + 40)
    elif case == "empty":
        mtx = MtxData.from_arrays([], [], np.zeros(0), n_rows=9, n_cols=9)
    got = mtx.row_counts()
    want = np.bincount(mtx.I, minlength=mtx.n_rows).astype(np.int64)
    assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("threshold", [4, 16, 1000])
def test_split_with_given_row_counts_equals_split_alone(threshold):
    mtx = tgen.random_imbalanced(1500, 8)
    a, pa = split_heavy_rows(mtx, threshold)
    b, pb = split_heavy_rows(mtx, threshold, mtx.row_counts())
    assert (pa is None) == (pb is None)
    if pa is not None:
        assert np.array_equal(pa, pb)
    for k, v in vars(a).items():
        w = getattr(b, k)
        assert (np.array_equal(v, w) and v.dtype == w.dtype
                if isinstance(v, np.ndarray) else v == w), k


@pytest.mark.parametrize("C,sigma", [(1, 1), (32, 1), (1024, 1), (64, 256)])
def test_guard_with_given_row_counts_equals_guard_alone(C, sigma):
    n = 40000
    heavy = MtxData.from_arrays(  # one 20k row: explodes at C=1024, sigma=1
        np.concatenate([np.zeros(20000), np.arange(n)]),
        np.concatenate([np.arange(20000), np.arange(n)]),
        np.ones(20000 + n), n_rows=n, n_cols=n).sort_by_row()
    for mtx in (heavy, tgen.random_imbalanced(3000, 8)):
        with warnings.catch_warnings(record=True) as w1:
            warnings.simplefilter("always")
            alone = guard_scs_explosion(mtx, C, sigma)
        with warnings.catch_warnings(record=True) as w2:
            warnings.simplefilter("always")
            given = guard_scs_explosion(mtx, C, sigma, mtx.row_counts())
        assert alone == given
        assert [str(w.message) for w in w1] == [str(w.message) for w in w2]


def test_from_mtx_counts_the_rows_once(monkeypatch):
    calls = []
    real = MtxData.row_counts

    def counting(self):
        calls.append(self.nnz)
        return real(self)

    monkeypatch.setattr(MtxData, "row_counts", counting)
    op_of(tgen.random_imbalanced(2000, 8), split_rows_threshold=16)
    assert len(calls) == 1
    calls.clear()
    op_of(tgen.laplace3d(8), kernel_format="crs", chunk_size=1)  # no count
    assert calls == []


# --------------------------- the device buffers against the host route


def host_route(config: Config, mtx: MtxData):
    """The SCS per precision and the pieces' arguments as a build that
    copies the matrix, counts its rows in each step, permutes every column
    and flattens the row index on the host makes them."""
    m = mtx.copy()
    if not m.is_sorted:
        m = m.sort_by_row()
    C, sigma = config.chunk_size, config.sigma
    n_real = m.n_rows
    th = split_threshold(config, m, C)
    parent = None
    if th:
        m, parent = split_heavy_rows(m, th)
    C, sigma = guard_scs_explosion(real_rows(m, n_real), C, sigma)
    if config.is_ap:
        subs, _ = partition_precisions(m, config.value_type,
                                       config.ap_threshold_1,
                                       config.ap_threshold_2)
    else:
        p = config.value_type
        subs = {p: dataclasses.replace(
            m, values=host_values(m.values, p).copy())}
    precs = list(subs)
    primary = convert_to_scs(real_rows(subs[precs[0]], n_real), C, sigma)
    scs = {precs[0]: primary}
    for p in precs[1:]:
        scs[p] = convert_to_scs(real_rows(subs[p], n_real), C, sigma,
                                fixed_permutation=primary.old_to_new_idx)
    full_perm = np.arange(primary.n_rows_padded, dtype=np.int32)
    full_perm[: primary.n_rows] = primary.old_to_new_idx
    for s in scs.values():
        permute_scs_cols(s, full_perm)
    pieces = {}
    if parent is not None:
        for p, sub in subs.items():
            cut = int(np.searchsorted(sub.I, n_real))
            if cut < sub.nnz:
                pieces[p] = (sub.I[cut:].astype(np.int64) - n_real,
                             full_perm[sub.J[cut:]], sub.values[cut:],
                             primary.old_to_new_idx[parent],
                             primary.n_rows_padded)
    return scs, pieces


def same_tensors(a, b, skip=()):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        u, v = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v), f.name
        else:
            assert u == v, f.name


@pytest.mark.parametrize("kw", [
    dict(chunk_size=32, sigma=1),
    dict(chunk_size=32, sigma=8),
    dict(chunk_size=16, sigma=128, value_type="sp"),
    dict(chunk_size=32, sigma=1, value_type="hp"),
    dict(chunk_size=32, sigma=1, split_rows_threshold=16),
    dict(chunk_size=16, sigma=64, split_rows_threshold=12),
    dict(chunk_size=32, sigma=4, value_type="ap[dp_sp]", ap_threshold_1=1.5,
         split_rows_threshold=16),
    dict(chunk_size=32, sigma=16, mixed_tiles=True, split_rows_threshold=16),
    dict(chunk_size=32, sigma=1, unsorted=True),
], ids=["sigma1", "sigma8", "sp-sigma128", "hp", "pieces",
        "pieces-sigma64", "ap-pieces", "packed-pieces", "unsorted"])
def test_device_buffers_equal_the_host_route(kw):
    kw = dict(kw)
    mtx = tgen.random_imbalanced(3000, 8)
    if kw.pop("unsorted", False):
        mtx = shuffled(mtx)
    op = op_of(mtx, **kw)
    scs, pieces = host_route(op.config, mtx)
    assert list(op.scs) == list(scs)
    if kw["sigma"] > 1:  # the permutation moved rows, so columns moved
        assert not np.array_equal(op.old_to_new, np.arange(op.n_rows))
    for p, ref in scs.items():
        got = op.scs[p]
        for f in dataclasses.fields(ref):
            u, v = getattr(got, f.name), getattr(ref, f.name)
            assert (np.array_equal(u, v) and u.dtype == v.dtype
                    if isinstance(v, np.ndarray) else u == v), f.name
        dev = op.devs[p]
        if isinstance(dev, DevicePacked):
            same_tensors(dev, build_device_packed(ref, CPU, dtype_for(p)))
            continue
        lengths, n_read = group_table(ref)
        assert dev.n_read == n_read
        assert torch.equal(dev.group_lengths, torch.from_numpy(lengths))
        assert torch.equal(dev.col_idxs, torch.from_numpy(ref.col_idxs))
        assert torch.equal(dev.chunk_ptrs, torch.from_numpy(ref.chunk_ptrs))
        assert torch.equal(dev.chunk_lengths,
                           torch.from_numpy(ref.chunk_lengths))
        want = torch.from_numpy(ref.values).to(dtype_for(p))
        assert dev.values.dtype == want.dtype
        assert torch.equal(dev.values, want)
        assert torch.equal(dev.row_idxs, torch.from_numpy(ref.flat_row_idx()))
    assert set(op.pieces) == set(pieces)
    for p, (ids, cols, vals, parent_row, n_pad) in pieces.items():
        same_tensors(op.pieces[p], build_device_pieces(
            ids, cols, vals, parent_row, n_pad, CPU, dtype_for(p),
            op.config.working_dtype(), op.config.block_vec_size))


@pytest.mark.parametrize("kw,gathers", [
    (dict(sigma=1), 0),
    (dict(sigma=1, value_type="ap[dp_sp]", ap_threshold_1=1.5), 0),
    (dict(sigma=8), 1),
    (dict(sigma=8, value_type="ap[dp_sp]", ap_threshold_1=1.5), 2),
], ids=["sigma1", "ap-sigma1", "sigma8", "ap-sigma8"])
def test_columns_are_gathered_only_through_a_permutation(
        monkeypatch, kw, gathers):
    from uspmv_tpu_torch.runtime import operator

    calls = []
    monkeypatch.setattr(operator, "permute_scs_cols",
                        lambda s, p: calls.append(permute_scs_cols(s, p)))
    op_of(tgen.random_imbalanced(2000, 8), **kw)
    assert len(calls) == gathers
