"""The host structures of row-sharded execution in uspmv_tpu_torch against
the JAX package, bit for bit, on the CPU.

``MtxData.slice_rows``, ``ScsData.padding_mask``, the row partitioners
(``parallel/partition.py``), the halo plan and its column renumbering
(``build_halo_plan``, with ``extra_cols``), the allgather column map and the
interior/halo split of the overlap must give the JAX functions' arrays for
the same input. Then the plan flattened into the (src, dst) rows of the
exchange (``exchange_rows``) against a numpy walk of the JAX exchange
(pack, ring permute, scatter), and the exchange wrapper on CPU tensors
against its plain version. The exchange kernel itself is checked on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.formats.coo import MtxData as JMtxData
from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.parallel import halo as jhalo
from uspmv_tpu.parallel import partition as jpart
from uspmv_tpu.parallel.distributed import _split_scs_for_overlap

from uspmv_tpu_torch.formats.coo import MtxData
from uspmv_tpu_torch.formats.scs import convert_to_scs
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.halo_exchange import (
    build_device_exchange,
    halo_exchange,
    halo_exchange_plain,
    launch_counts,
)
from uspmv_tpu_torch.parallel import halo as thalo
from uspmv_tpu_torch.parallel import partition as tpart
from uspmv_tpu_torch.parallel.distributed import split_scs_for_overlap

CPU = torch.device("cpu")


def scattered(g, cls):
    """A 2-D Laplacian with its rows and columns scattered by a fixed
    permutation: seg-metis must find the bands again."""
    m = g.laplace2d(12)
    perm = np.random.default_rng(5).permutation(m.n_rows)
    return m.permute(perm, None).sort_by_row()


def hot_last_row(g, cls):
    """nnz concentrated in the last row (the empty-shard guard)."""
    I = np.concatenate([np.arange(10), np.full(500, 9)])
    J = np.concatenate([np.arange(10), np.arange(500) % 10])
    return cls.from_arrays(I, J, np.ones(I.size), 10, 10).sort_by_row()


def hot_first_row(g, cls):
    I = np.concatenate([np.full(500, 0), np.arange(10)])
    J = np.concatenate([np.arange(500) % 10, np.arange(10)])
    return cls.from_arrays(I, J, np.ones(I.size), 10, 10).sort_by_row()


MATRICES = {
    "laplace2d(16)": lambda g, cls: g.laplace2d(16),
    "random_imbalanced(400,8)": lambda g, cls: g.random_imbalanced(
        400, 8, seed=3),
    "fem_tet3d(4)": lambda g, cls: g.fem_tet3d(4),
    "scattered_laplace2d(12)": scattered,
    "hot_last_row": hot_last_row,
    "hot_first_row": hot_first_row,
}


def both(name):
    return MATRICES[name](jgen, JMtxData), MATRICES[name](tgen, MtxData)


def assert_same(a, b, what=""):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def assert_same_scs(js, ts):
    for f in dataclasses.fields(js):
        assert_same(getattr(js, f.name), getattr(ts, f.name), f.name)


# ----------------------------------------------------- COO and SCS helpers


@pytest.mark.parametrize("bounds", [(0, 5), (37, 200), (390, 400)])
def test_slice_rows_matches_jax(bounds):
    jm, tm = both("random_imbalanced(400,8)")
    js, ts = jm.slice_rows(*bounds), tm.slice_rows(*bounds)
    for f in ("n_rows", "n_cols", "nnz", "is_sorted", "is_symmetric"):
        assert getattr(js, f) == getattr(ts, f), f
    for f in ("I", "J", "values"):
        assert_same(getattr(js, f), getattr(ts, f), f)


@pytest.mark.parametrize("C,sigma", [(1, 1), (4, 8), (32, 1), (7, 64)])
@pytest.mark.parametrize("name", ["random_imbalanced(400,8)", "hot_last_row"])
def test_padding_mask_matches_jax(name, C, sigma):
    jm, tm = both(name)
    js, ts = j_convert(jm, C, sigma), convert_to_scs(tm, C, sigma)
    assert_same(js.padding_mask(), ts.padding_mask())
    assert int((~ts.padding_mask()).sum()) == ts.nnz


# ------------------------------------------------------------ partitioners


@pytest.mark.parametrize("method", ["seg-rows", "seg-nnz", "seg-metis"])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["laplace2d(16)", "random_imbalanced(400,8)",
                                  "fem_tet3d(4)", "scattered_laplace2d(12)"])
def test_seg_work_sharing_matches_jax(name, R, method):
    jm, tm = both(name)
    jws, jperm = jpart.seg_work_sharing(jm, R, method)
    tws, tperm = tpart.seg_work_sharing(tm, R, method)
    assert_same(jws, tws, "work_sharing")
    assert_same(jperm, tperm, "global permutation")
    assert np.all(np.diff(tws) > 0) and tws[0] == 0 and tws[-1] == tm.n_rows


@pytest.mark.parametrize("name", ["hot_last_row", "hot_first_row"])
def test_seg_nnz_empty_shard_guard_matches_jax(name):
    jm, tm = both(name)
    for R in (2, 4, 10):
        jws, _ = jpart.seg_work_sharing(jm, R, "seg-nnz")
        tws, _ = tpart.seg_work_sharing(tm, R, "seg-nnz")
        assert_same(jws, tws)
        assert np.all(np.diff(tws) > 0)


@pytest.mark.parametrize("method", ["seg-rows", "seg-nnz", "seg-metis"])
def test_too_many_shards_raises_as_in_jax(method):
    jm, tm = both("hot_last_row")
    with pytest.raises(ValueError, match="reduce n_shards"):
        jpart.seg_work_sharing(jm, 11, method)
    with pytest.raises(ValueError, match="reduce n_shards"):
        tpart.seg_work_sharing(tm, 11, method)
    with pytest.raises(ValueError, match="unknown seg method"):
        tpart.seg_work_sharing(tm, 2, "seg-cols")
    with pytest.raises(ValueError, match=">= 1"):
        tpart.seg_work_sharing(tm, 0, method)


@pytest.mark.parametrize("name", ["laplace2d(16)", "fem_tet3d(4)",
                                  "scattered_laplace2d(12)"])
def test_partition_helpers_match_jax(name):
    jm, tm = both(name)
    assert_same(jpart.cuthill_mckee_permutation(jm),
                tpart.cuthill_mckee_permutation(tm))
    for a, b in zip(jpart._sym_csr(jm), tpart._sym_csr(tm)):
        assert_same(a, b)
    for R in (3, 4):
        part = tpart.greedy_graph_growing(tm, R)
        assert_same(jpart.greedy_graph_growing(jm, R), part)
        assert_same(jpart.partition_to_permutation(part),
                    tpart.partition_to_permutation(part))
        ws = tpart._seg_nnz(tm, R)
        assert_same(jpart._seg_nnz(jm, R), ws)
        assert_same(jpart._seg_rows(tm.n_rows, R), tpart._seg_rows(tm.n_rows, R))
        assert jpart.halo_comm_volume(jm, ws) == tpart.halo_comm_volume(tm, ws)


# -------------------------------------------------------------- halo plans


def shard_scs(name, R, method, C, sigma):
    """Per-shard SCS of both packages (global columns), as the operators
    build them: seg_work_sharing, the seg-metis permutation, slice_rows,
    convert_to_scs."""
    jm, tm = both(name)
    ws, perm = tpart.seg_work_sharing(tm, R, method)
    if perm is not None:
        jm = jm.permute(perm, None).sort_by_row()
        tm = tm.permute(perm, None).sort_by_row()
    js = [j_convert(jm.slice_rows(int(ws[r]), int(ws[r + 1])), C, sigma)
          for r in range(R)]
    ts = [convert_to_scs(tm.slice_rows(int(ws[r]), int(ws[r + 1])), C, sigma)
          for r in range(R)]
    for a, b in zip(js, ts):
        assert_same_scs(a, b)
    return ws, js, ts


def extra_columns(ws, n_cols, seed):
    rng = np.random.default_rng(seed)
    return [None if r % 3 == 2 else rng.integers(0, n_cols, 7)
            for r in range(len(ws) - 1)]


def assert_same_plan(jp, tp):
    assert jp.n_shards == tp.n_shards and jp.H == tp.H
    assert jp.offsets == tp.offsets
    assert list(jp.n_rows_padded) == list(tp.n_rows_padded)
    assert list(jp.halo_counts) == list(tp.halo_counts)
    assert_same(jp.work_sharing, tp.work_sharing)
    assert_same(jp.recv_counts, tp.recv_counts)
    for d in jp.offsets:
        assert_same(jp.send_gather_idx[d], tp.send_gather_idx[d], f"gather {d}")
        assert_same(jp.recv_scatter_idx[d], tp.recv_scatter_idx[d],
                    f"scatter {d}")
        assert_same(jp.real_counts[d], tp.real_counts[d], f"counts {d}")
    for a, b in zip(jp.halo_cols, tp.halo_cols):
        assert_same(a, b, "halo_cols")
    assert jp.comm_volume_per_spmv == tp.comm_volume_per_spmv
    assert jp.padded_comm_volume_per_spmv == tp.padded_comm_volume_per_spmv


PLAN_CASES = [
    ("laplace2d(16)", 4, "seg-rows", 4, 8),
    ("laplace2d(16)", 8, "seg-nnz", 1, 1),
    ("random_imbalanced(400,8)", 4, "seg-nnz", 8, 16),
    ("random_imbalanced(400,8)", 3, "seg-rows", 32, 1),
    ("fem_tet3d(4)", 4, "seg-metis", 16, 4),
    ("scattered_laplace2d(12)", 4, "seg-metis", 4, 1),
]


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("name,R,method,C,sigma", PLAN_CASES)
def test_build_halo_plan_matches_jax(name, R, method, C, sigma, extra):
    ws, js, ts = shard_scs(name, R, method, C, sigma)
    ex = extra_columns(ws, ts[0].n_cols, seed=R) if extra else None
    jp = jhalo.build_halo_plan(js, ws, extra_cols=ex)
    tp = thalo.build_halo_plan(ts, ws, extra_cols=ex)
    assert_same_plan(jp, tp)
    for a, b in zip(js, ts):  # the renumbered columns
        assert_same_scs(a, b)


@pytest.mark.parametrize("name,R,method,C,sigma", PLAN_CASES[:3])
def test_halo_plan_without_renumbering_matches_jax(name, R, method, C, sigma):
    ws, js, ts = shard_scs(name, R, method, C, sigma)
    before = [s.col_idxs.copy() for s in ts]
    assert_same_plan(jhalo.build_halo_plan(js, ws, renumber=False),
                     thalo.build_halo_plan(ts, ws, renumber=False))
    for s, cols in zip(ts, before):
        assert_same(s.col_idxs, cols)


@pytest.mark.parametrize("name,R,method,C,sigma", PLAN_CASES)
def test_allgather_col_map_matches_jax(name, R, method, C, sigma):
    ws, js, ts = shard_scs(name, R, method, C, sigma)
    stride = max(s.n_rows_padded for s in ts)
    jhalo.build_allgather_col_map(js, ws, stride)
    thalo.build_allgather_col_map(ts, ws, stride)
    for a, b in zip(js, ts):
        assert_same_scs(a, b)


@pytest.mark.parametrize("name,R,method,C,sigma", PLAN_CASES)
def test_overlap_split_matches_jax(name, R, method, C, sigma):
    ws, js, ts = shard_scs(name, R, method, C, sigma)
    jhalo.build_halo_plan(js, ws)
    thalo.build_halo_plan(ts, ws)
    for a, b in zip(js, ts):
        (ji, jh), (ti, th) = _split_scs_for_overlap(a), split_scs_for_overlap(b)
        assert_same_scs(ji, ti)
        assert_same_scs(jh, th)
        assert ti.nnz + th.nnz == b.nnz


# ---------------------------------------------------------- the exchange


def jax_exchange_walk(plan, xs, no_pack=False):
    """numpy walk of the JAX exchange (distributed.py:917-944): each
    shard's x padded to H + 1, then per offset the padded pack (gather, or
    the first max_d rows under no_pack), the ring permute r -> r + d and
    the scatter, padding lanes into the dump slot H."""
    R, H = plan.n_shards, plan.H
    xb = [np.concatenate([x, np.zeros((H + 1 - x.shape[0],) + x.shape[1:])])
          for x in xs]
    for d in plan.offsets:
        g, s = plan.send_gather_idx[d], plan.recv_scatter_idx[d]
        send = [xb[r][:g.shape[1]] if no_pack else xb[r][g[r]]
                for r in range(R)]
        for r in range(R):
            xb[r][s[r]] = send[(r - d) % R]
    return xb


def stacked(xs, L, bs, layout):
    R = len(xs)
    out = np.zeros((R, L) + ((bs,) if bs > 1 else ()))
    for r, x in enumerate(xs):
        out[r, :x.shape[0]] = x
    if bs > 1 and layout == "colwise":
        out = np.ascontiguousarray(np.moveaxis(out, -1, 0))
    return torch.from_numpy(out)


def unstack(t, bs, layout):
    a = t.numpy()
    return np.moveaxis(a, 0, -1) if bs > 1 and layout == "colwise" else a


@pytest.mark.parametrize("no_pack", [False, True])
@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 3),
                                       ("colwise", 3)])
@pytest.mark.parametrize("name,R,method,C,sigma", PLAN_CASES)
def test_exchange_rows_reproduce_the_jax_exchange(name, R, method, C, sigma,
                                                  layout, bs, no_pack):
    ws, _, ts = shard_scs(name, R, method, C, sigma)
    plan = thalo.build_halo_plan(ts, ws)
    n_loc = max(s.n_rows_padded for s in ts)
    L = max(plan.H, n_loc) + 1
    rng = np.random.default_rng(R)
    xs = [rng.standard_normal((n_loc,) + ((bs,) if bs > 1 else ()))
          for _ in range(R)]
    want = jax_exchange_walk(plan, xs, no_pack)
    src, dst = thalo.exchange_rows(plan, L, no_pack=no_pack)
    ex = build_device_exchange(src, dst, R, L, CPU)
    x = stacked(xs, L, bs, layout)
    n0 = sum(launch_counts().values())
    got = unstack(halo_exchange(ex, x, layout), bs, layout)
    assert sum(launch_counts().values()) == n0  # the plain version ran
    for r in range(R):
        # every row but the dump slot, which only padding lanes write
        assert np.array_equal(got[r][:plan.H], want[r][:plan.H])
    assert ex.n == plan.comm_volume_per_spmv
    assert (np.asarray(src) % L < n_loc).all()
    assert len(set(np.asarray(dst).tolist())) == ex.n


def test_exchange_checks_its_arguments():
    ws, _, ts = shard_scs("laplace2d(16)", 4, "seg-rows", 4, 1)
    plan = thalo.build_halo_plan(ts, ws)
    with pytest.raises(ValueError, match="must exceed"):
        thalo.exchange_rows(plan, plan.H)
    src, dst = thalo.exchange_rows(plan, plan.H + 1)
    with pytest.raises(ValueError, match="both a source and a destination"):
        build_device_exchange(np.append(src, dst[0]), np.append(dst, 0), 4,
                              plan.H + 1, CPU)
    ex = build_device_exchange(src, dst, 4, plan.H + 1, CPU)
    with pytest.raises(ValueError, match="stacked buffer"):
        halo_exchange(ex, torch.zeros(4, plan.H), "rowwise")
    with pytest.raises(TypeError, match="float32 or float64"):
        halo_exchange(ex, torch.zeros(4, plan.H + 1, dtype=torch.bfloat16))
    x = torch.arange(4.0 * (plan.H + 1)).reshape(4, -1)
    y = halo_exchange_plain(ex, x.clone())
    assert torch.equal(halo_exchange(ex, x, "rowwise"), y)
