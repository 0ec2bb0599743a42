"""The CUDA kernel of uspmv_tpu_torch on the card, against its plain
PyTorch version. These tests need an NVIDIA Hopper GPU and nvcc; elsewhere
they skip. This file imports no JAX, so on a GPU host without JAX it runs
on its own:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.coo import MtxData
from uspmv_tpu_torch.io.generators import laplace2d, random_banded, tridiag
from uspmv_tpu_torch.ops import scs_spmv
from uspmv_tpu_torch.ops.device_format import build_device_scs
from uspmv_tpu_torch.ops.scs_spmv import launch_count, spmv_scs, spmv_scs_plain
from uspmv_tpu_torch.runtime.operator import SpmvOperator, graph_nodes_replayed

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max|plain|: the plain index_add_ sums in another
# order and the kernel contracts to FMAs
TOL = {"sp": 1e-5, "dp": 1e-12}
# the same, by accumulator (x) dtype
ACC_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def with_empty_rows():
    """Rows 0, 5, 6 and the last rows empty; one row much longer."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.repeat(np.arange(1, 5), 3),
                           np.repeat(np.arange(7, 90), 2), np.full(40, 50)])
    cols = rng.integers(0, 100, rows.size)
    key, first = np.unique(rows * 100 + cols, return_index=True)
    return MtxData.from_arrays(rows[first], cols[first],
                               rng.standard_normal(first.size),
                               n_rows=100, n_cols=100).sort_by_row()


CASES = {
    "tridiag-crs": (lambda: tridiag(1000), 1, 1),
    "tridiag-c32": (lambda: tridiag(1000), 32, 1),
    "laplace2d-c7-s4": (lambda: laplace2d(33), 7, 4),
    "banded-c1024-s512": (lambda: random_banded(5000, 60, 11), 1024, 512),
    "empty-rows-c32-s8": (with_empty_rows, 32, 8),
}


@pytest.mark.parametrize("value_type", ["sp", "dp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, value_type):
    make, C, sigma = CASES[case]
    mtx = make()
    # the SELL-C-sigma kernel on the whole rows, whatever their fill
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=C, sigma=sigma,
               value_type=value_type, backend="cuda",
               split_rows_threshold=-1, mixed_tiles=False), mtx)
    (dev,) = op.devs.values()
    x = op.make_x(np.random.default_rng(0).standard_normal(mtx.n_rows))
    n0 = launch_count()
    y = spmv_scs(dev, x)
    torch.cuda.synchronize()
    assert launch_count() == n0 + 1
    y_plain = spmv_scs_plain(dev, x)
    assert y.shape == y_plain.shape == (dev.n_rows_padded,)
    err = (y - y_plain).abs().max().item()
    assert err <= TOL[value_type] * max(y_plain.abs().max().item(), 1e-30)


def test_operator_on_card_matches_cpu(cuda):
    mtx = random_banded(3000, 40, 9)
    cfg = dict(kernel_format="scs", chunk_size=32, sigma=64, value_type="sp")
    gpu = SpmvOperator.from_mtx(Config(backend="cuda", **cfg), mtx)
    cpu = SpmvOperator.from_mtx(Config(backend="cpu", **cfg), mtx)
    assert gpu.impl_name() == "cuda-scs-sp"
    x = np.random.default_rng(1).standard_normal(mtx.n_rows)
    _, y_gpu = gpu.solve(gpu.make_x(x), 3)
    _, y_cpu = cpu.solve(cpu.make_x(x), 3)
    a, b = gpu.to_host(y_gpu), cpu.to_host(y_cpu)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_wrapper_rejects_mismatched_tensors(cuda):
    op = SpmvOperator.from_mtx(
        Config(kernel_format="crs", value_type="sp", backend="cuda"),
        tridiag(50))
    (dev,) = op.devs.values()
    with pytest.raises(ValueError, match="is on"):
        spmv_scs(dev, torch.zeros(dev.n_rows_padded))
    with pytest.raises(TypeError, match="dtype"):
        spmv_scs(dev, torch.zeros(dev.n_rows_padded, dtype=torch.float16,
                                  device=cuda))
    dp = SpmvOperator.from_mtx(
        Config(kernel_format="crs", value_type="dp", backend="cuda"),
        tridiag(50))
    (dev64,) = dp.devs.values()
    with pytest.raises(TypeError, match="no SCS kernel"):
        spmv_scs(dev64, torch.zeros(dev64.n_rows_padded, device=cuda))
    with pytest.raises(ValueError, match="accumulate"):
        spmv_scs(dev, torch.zeros(dev.n_rows_padded, device=cuda),
                 y=torch.zeros(3, device=cuda))


def banded_dev(value_dtype, device):
    """random_banded(5000, 60, 11) at C=128, sigma=32 with values rounded
    to ``value_dtype`` on the host, on ``device``."""
    from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols

    m = random_banded(5000, 60, 11)
    scs = convert_to_scs(m, 128, 32)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, perm)
    scs.values = torch.from_numpy(scs.values).to(value_dtype).double().numpy()
    return build_device_scs(scs, device, value_dtype)


PAIRS = list(scs_spmv._ENTRY_POINTS)


# (layout, bs): bs=1 is one vector [n_pad]; rowwise bs=11 takes two passes
SHAPES = [("rowwise", 1), ("rowwise", 4), ("rowwise", 8), ("rowwise", 11),
          ("colwise", 4), ("colwise", 8)]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("layout,bs", SHAPES)
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_every_instantiation_matches_plain(cuda, pair, layout, bs, accumulate):
    vdt, xdt = pair
    dev = banded_dev(vdt, cuda)
    n = dev.n_rows_padded
    shape = (n,) if bs == 1 else (n, bs) if layout == "rowwise" else (bs, n)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=gen, dtype=torch.float64).to(xdt)
    y0 = torch.randn(shape, generator=gen, dtype=torch.float64).to(xdt)
    x, y0 = x.to(cuda), y0.to(cuda)
    name = scs_spmv.entry_point(vdt, xdt)
    before = scs_spmv.launch_counts()[name]
    y = spmv_scs(dev, x, layout, y0.clone() if accumulate else None)
    torch.cuda.synchronize()
    passes = -(-bs // 8) if layout == "rowwise" else 1
    assert scs_spmv.launch_counts()[name] == before + passes
    ref = spmv_scs_plain(dev, x, layout, y0.clone() if accumulate else None)
    assert y.dtype == xdt and y.shape == ref.shape == shape
    err = (y - ref).abs().max().item()
    assert err <= ACC_TOL[xdt] * max(ref.abs().max().item(), 1e-30)


# ------------------------------------------------------------- solve mode

SOLVE_PAIRS = [(torch.float64, torch.float64), (torch.float32, torch.float32),
               (torch.bfloat16, torch.float32)]


def contraction(dev):
    """Scale the values so the row sums of |A| are <= 1: iterates of
    x <- A x stay finite for any k."""
    rowsum = torch.zeros(dev.n_rows_padded, dtype=torch.float64,
                         device=dev.device)
    rowsum.index_add_(0, dev.row_idxs.long(), dev.values.double().abs())
    dev.values = (dev.values.double() / rowsum.max()).to(dev.values.dtype)
    return dev


@pytest.mark.parametrize("k", [1, 2, 5, 64])
@pytest.mark.parametrize("bs", [1, 3, 4, 8])
@pytest.mark.parametrize("pair", SOLVE_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_fused_solve_equals_k_launches_bit_for_bit(cuda, pair, bs, k):
    from uspmv_tpu_torch.ops import scs_solve

    vdt, xdt = pair
    dev = contraction(banded_dev(vdt, cuda))
    n = dev.n_rows_padded
    gen = torch.Generator().manual_seed(k)
    x = torch.randn((n,) if bs == 1 else (n, bs), generator=gen,
                    dtype=torch.float64).to(xdt).to(cuda)
    x0 = x.clone()
    name = scs_solve.entry_point(vdt, xdt)
    before = scs_solve.launch_counts()[name]
    prev, fin = scs_solve.solve_scs(dev, x, k)
    torch.cuda.synchronize()
    assert scs_solve.launch_counts()[name] == before + 1
    assert torch.equal(x, x0)  # x0 is only read
    want_prev, want = x, x
    for _ in range(k):
        want_prev, want = want, spmv_scs(dev, want)
    assert torch.equal(fin, want) and torch.equal(prev, want_prev)
    p_prev, p_fin = scs_solve.solve_scs_plain(dev, x, k)
    scale = max(p_fin.abs().max().item(), 1e-30)
    assert (fin - p_fin).abs().max().item() <= ACC_TOL[xdt] * scale
    scale = max(p_prev.abs().max().item(), 1e-30)
    assert (prev - p_prev).abs().max().item() <= ACC_TOL[xdt] * scale


SOLVE_OPERATORS = {
    "sp": dict(value_type="sp"),
    "dp": dict(value_type="dp"),
    "hp": dict(value_type="hp"),
    "ap[sp_hp]": dict(value_type="ap[sp_hp]", ap_threshold_1=0.3),
    "sp-colwise-4": dict(value_type="sp", block_vec_size=4,
                         vector_layout="colwise"),
    "sp-rowwise-11": dict(value_type="sp", block_vec_size=11,
                          vector_layout="rowwise"),
}


@pytest.mark.parametrize("k", [2, 7])
@pytest.mark.parametrize("case", sorted(SOLVE_OPERATORS))
def test_graph_solve_equals_loop_bit_for_bit(cuda, case, k):
    mtx = laplace2d(33)
    mtx.values[:] = mtx.values * 0.1
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=8, backend="cuda",
               **SOLVE_OPERATORS[case]), mtx)
    assert op.solve_impl_name(k) == "graph"
    bs = op.config.block_vec_size
    x = op.make_x(np.random.default_rng(k).standard_normal(
        (mtx.n_rows, bs) if bs > 1 else mtx.n_rows))
    a_prev, a = op.solve(x, k, impl="loop")
    per_iter = len(op.devs) * (-(-bs // 8) if op.config.vector_layout
                               == "rowwise" else 1)
    for _ in range(2):  # the capture, then a replay of the cached graph
        n0, g0 = launch_count(), sum(graph_nodes_replayed().values())
        b_prev, b = op.solve(x, k)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a_prev, b_prev)
    # a replay counts its kernel nodes, k iterations of every stream, apart
    # from the wrapper's launch count: it launched nothing itself
    assert sum(graph_nodes_replayed().values()) - g0 == k * per_iter
    assert launch_count() == n0
    if op.fused_solve_eligible():
        c_prev, c = op.solve(x, k, impl="fused")
        assert torch.equal(a, c) and torch.equal(a_prev, c_prev)
    else:
        with pytest.raises(ValueError, match="fused solve kernel takes"):
            op.solve(x, k, impl="fused")


def test_graph_results_survive_the_next_solve(cuda):
    mtx = laplace2d(33)
    mtx.values[:] = mtx.values * 0.1
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=8, value_type="sp",
               backend="cuda"), mtx)
    rng = np.random.default_rng(0)
    x1 = op.make_x(rng.standard_normal(mtx.n_rows))
    x2 = op.make_x(rng.standard_normal(mtx.n_rows))
    prev1, y1 = op.solve(x1, 4, impl="graph")
    keep = (prev1.clone(), y1.clone())
    op.solve(x2, 4, impl="graph")  # replays over the same static buffers
    torch.cuda.synchronize()
    assert torch.equal(prev1, keep[0]) and torch.equal(y1, keep[1])


def test_graph_cache_is_bounded(cuda):
    from uspmv_tpu_torch.runtime.operator import MAX_SOLVE_GRAPHS

    mtx = laplace2d(33)
    mtx.values[:] = mtx.values * 0.1
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=8, value_type="sp",
               backend="cuda"), mtx)
    x = op.make_x(np.random.default_rng(0).standard_normal(mtx.n_rows))
    ks = list(range(2, MAX_SOLVE_GRAPHS + 5))
    for k in ks + [2]:  # k=2 was evicted and is captured again
        want = op.solve(x, k, impl="loop")
        got = op.solve(x, k, impl="graph")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert len(op._solve_graphs) <= MAX_SOLVE_GRAPHS
    assert [key[0] for key in op._solve_graphs] == ks[-(MAX_SOLVE_GRAPHS - 1):] + [2]


def test_bench_solve_on_the_card(cuda):
    from uspmv_tpu_torch.ops import scs_solve
    from uspmv_tpu_torch.runtime.bench import bench_solve

    mtx = laplace2d(33)
    mtx.values[:] = mtx.values * 0.1
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=8, value_type="sp",
               backend="cuda"), mtx)
    for impl in ("loop", "graph", "fused"):
        n0, f0 = launch_count(), scs_solve.launch_count()
        g0 = sum(graph_nodes_replayed().values())
        res = bench_solve(op, 16, bench_time=0.02, warmup=1, impl=impl)
        nodes = sum(graph_nodes_replayed().values()) - g0
        assert res.impl == f"solve-{impl}[cuda-scs-sp]"
        assert res.n_iterations % 16 == 0 and res.perf_gflops > 0
        if impl == "fused":
            assert scs_solve.launch_count() > f0 and launch_count() == n0
        elif impl == "graph":
            assert nodes >= res.n_iterations
        else:
            assert launch_count() - n0 >= res.n_iterations and nodes == 0


# ------------------------------------------- heavy-row pieces, packed rows

def imbalanced():
    """random_imbalanced(4000, 8) plus row 7 filled to 3,000 elements: with
    threshold 2 that row has more pieces than a warp has lanes, with 1024
    its pieces are longer than a warp."""
    from uspmv_tpu_torch.io.generators import random_imbalanced

    m = random_imbalanced(4000, 8)
    rng = np.random.default_rng(5)
    cols = rng.permutation(4000)[:3000]
    I = np.concatenate([m.I, np.full(cols.size, 7)])
    J = np.concatenate([m.J, cols])
    V = np.concatenate([m.values, rng.standard_normal(cols.size)])
    _, first = np.unique(I.astype(np.int64) * 4000 + J, return_index=True)
    return MtxData.from_arrays(I[first], J[first], V[first], 4000,
                               4000).sort_by_row()


def split_streams(mtx, th, C, sigma, value_dtype, acc_dtype, n_vec, device,
                  packed=False):
    """The real rows (SELL-C-sigma or packed) and the pieces of ``mtx``
    split at ``th``, built by hand the way SpmvOperator.from_mtx does."""
    from uspmv_tpu_torch.formats.coo import split_heavy_rows
    from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols
    from uspmv_tpu_torch.ops.device_format import (
        build_device_packed,
        build_device_pieces,
    )

    n = mtx.n_rows
    m = mtx.copy()
    m.values = torch.from_numpy(m.values).to(value_dtype).double().numpy()
    split, parent = split_heavy_rows(m, th)
    assert parent is not None
    cut = int(np.searchsorted(split.I, n))
    real = MtxData.from_arrays(split.I[:cut], split.J[:cut],
                               split.values[:cut], n, n, is_sorted=True)
    scs = convert_to_scs(real, C, sigma)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[:n] = scs.old_to_new_idx
    permute_scs_cols(scs, perm)
    build = build_device_packed if packed else build_device_scs
    pieces = build_device_pieces(
        split.I[cut:].astype(np.int64) - n, perm[split.J[cut:]],
        split.values[cut:], scs.old_to_new_idx[parent], scs.n_rows_padded,
        device, value_dtype, acc_dtype, n_vec)
    return build(scs, device, value_dtype), pieces


def block_shape(n, layout, bs):
    return (n,) if bs == 1 else (n, bs) if layout == "rowwise" else (bs, n)


def randn_pair(shape, xdt, device, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float64).to(xdt)
    y0 = torch.randn(shape, generator=gen, dtype=torch.float64).to(xdt)
    return x.to(device), y0.to(device)


# the pieces' sums run in another order than index_add_: a few ulp times the
# square root of the longest row (3,000 here) on top of the SpMV tolerance
PIECES_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def check_pieces(pieces, x, y0, layout):
    """spmv_pieces twice against its plain version: one launch each, the
    same bits, the counters back at 0, the rows of no parent untouched."""
    from uspmv_tpu_torch.ops import scs_pieces

    name = scs_pieces.entry_point(pieces.values.dtype, x.dtype)
    before = scs_pieces.launch_counts()[name]
    y = scs_pieces.spmv_pieces(pieces, x, layout, y0.clone())
    again = scs_pieces.spmv_pieces(pieces, x, layout, y0.clone())
    torch.cuda.synchronize()
    assert scs_pieces.launch_counts()[name] == before + 2
    assert torch.equal(y, again)  # no float atomics: the same bits every run
    assert not pieces.arrivals.any() and not pieces.slots.any()
    ref = scs_pieces.spmv_pieces_plain(pieces, x, layout, y0.clone())
    err = (y - ref).abs().max().item()
    assert err <= PIECES_TOL[x.dtype] * max(ref.abs().max().item(), 1e-30)
    untouched = torch.ones(pieces.n_rows_padded, dtype=torch.bool,
                           device=x.device)
    untouched[pieces.parent_row.long()] = False
    rows = y if layout == "rowwise" or x.dim() == 1 else y.T
    assert torch.equal(rows[untouched], (y0 if rows is y else y0.T)[untouched])
    return y


@pytest.mark.parametrize("th", [2, 32, 1024])
@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 4),
                                       ("rowwise", 8), ("colwise", 4),
                                       ("colwise", 8)])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_pieces_match_plain_and_repeat_bit_for_bit(cuda, pair, layout, bs, th):
    vdt, xdt = pair
    _, pieces = split_streams(imbalanced(), th, 32, 64, vdt, xdt, bs, cuda)
    assert pieces.n_pieces >= (1500 if th == 2 else 2)
    x, y0 = randn_pair(block_shape(pieces.n_rows_padded, layout, bs), xdt,
                       cuda, th)
    check_pieces(pieces, x, y0, layout)


def parents_of(pieces_per_parent, th=4, n=2000, seed=8):
    """A matrix whose row 10 * i + 3 splits at ``th`` into
    pieces_per_parent[i] pieces (the last one shorter), over random rows
    of at most th elements."""
    rng = np.random.default_rng(seed)
    I, J = [], []
    for r in range(n):
        k = rng.integers(0, th + 1)
        I.append(np.full(k, r))
        J.append(rng.permutation(n)[:k])
    for i, p in enumerate(pieces_per_parent):
        r, k = 10 * i + 3, th + th * p - 1
        I[r] = np.full(k, r)
        J[r] = rng.permutation(n)[:k]
    I, J = np.concatenate(I), np.concatenate(J)
    return MtxData.from_arrays(I, J, rng.standard_normal(I.size), n,
                               n).sort_by_row()


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 4),
                                       ("colwise", 8)])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_pieces_short_and_long_parents(cuda, pair, layout, bs):
    """Parents of 1, 7, 8 (short: one record, up to full), 9 (two records),
    32, 33 and 300 pieces (a fold of 300 slots)."""
    from uspmv_tpu_torch.ops.device_format import RECORD_PIECES as R

    vdt, xdt = pair
    runs = [1, R - 1, R, R + 1, 32, 33, 300]
    _, pieces = split_streams(parents_of(runs), 4, 32, 8, vdt, xdt, bs, cuda)
    got = np.diff(pieces.parent_ptr.cpu().numpy())
    assert sorted(got[got > 1]) == sorted(p for p in runs if p > 1)
    assert pieces.longs.shape[0] == sum(p > R for p in runs)
    x, y0 = randn_pair(block_shape(pieces.n_rows_padded, layout, bs), xdt,
                       cuda, bs)
    check_pieces(pieces, x, y0, layout)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_pieces_graph_replays_equal_the_launch(cuda, pair):
    """Two replays of one captured graph give the launch's bits: the last
    record of each long parent resets its counter."""
    from uspmv_tpu_torch.ops import scs_pieces

    vdt, xdt = pair
    _, pieces = split_streams(imbalanced(), 2, 32, 64, vdt, xdt, 1, cuda)
    assert pieces.longs.shape[0] > 0
    x, y0 = randn_pair(pieces.n_rows_padded, xdt, cuda, 5)
    want = scs_pieces.spmv_pieces(pieces, x, "rowwise", y0.clone())
    y = y0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a warm-up outside the capture
        scs_pieces.spmv_pieces(pieces, x, "rowwise", y0.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with scs_spmv.record_captured_launches() as nodes:
        with torch.cuda.graph(graph):
            scs_pieces.spmv_pieces(pieces, x, "rowwise", y)
    assert nodes == {scs_pieces.entry_point(vdt, xdt): 1}
    for _ in range(2):
        y.copy_(y0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert not pieces.arrivals.any() and not pieces.slots.any()


PACKED_PAIRS = [(torch.float64, torch.float64), (torch.float32, torch.float32),
                (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("layout,bs", SHAPES)
@pytest.mark.parametrize("pair", PACKED_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_packed_matches_plain_and_repeats_bit_for_bit(cuda, pair, layout, bs,
                                                      accumulate):
    from uspmv_tpu_torch.ops import scs_packed

    vdt, xdt = pair
    dev, _ = split_streams(imbalanced(), 32, 32, 64, vdt, xdt, 1, cuda,
                           packed=True)
    shape = block_shape(dev.n_rows_padded, layout, bs)
    x, y0 = randn_pair(shape, xdt, cuda, bs)
    name = scs_packed.entry_point(vdt, xdt)
    before = scs_packed.launch_counts()[name]
    y = scs_packed.spmv_packed(dev, x, layout,
                               y0.clone() if accumulate else None)
    again = scs_packed.spmv_packed(dev, x, layout,
                                   y0.clone() if accumulate else None)
    torch.cuda.synchronize()
    assert scs_packed.launch_counts()[name] == before + 2
    assert torch.equal(y, again)
    ref = scs_packed.spmv_packed_plain(dev, x, layout,
                                       y0.clone() if accumulate else None)
    assert y.dtype == xdt and y.shape == ref.shape == shape
    err = (y - ref).abs().max().item()
    assert err <= ACC_TOL[xdt] * max(ref.abs().max().item(), 1e-30)


def test_packed_rows_without_elements_write_zero(cuda):
    """with_empty_rows at C=32: whole row groups' worth of empty rows, and
    the padded rows behind the last real one."""
    from uspmv_tpu_torch.ops.scs_packed import spmv_packed

    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=8, value_type="sp",
               backend="cuda", mixed_tiles=True, split_rows_threshold=-1),
        with_empty_rows())
    assert op.impl_name() == "cuda-packed-sp"
    (dev,) = op.devs.values()
    x = op.make_x(np.random.default_rng(0).standard_normal(100))
    out = torch.full((dev.n_rows_padded,), 7.0, device=cuda)
    spmv_packed(dev, x, out=out)
    counts = (dev.row_ptr[1:] - dev.row_ptr[:-1]).cpu()
    assert (counts == 0).sum() >= 30
    assert torch.equal(out.cpu()[counts == 0],
                       torch.zeros(int((counts == 0).sum())))


TIERS = {
    "scs+pieces": dict(mixed_tiles=False),
    "packed+pieces": dict(mixed_tiles=True),
    "packed": dict(mixed_tiles=True, split_rows_threshold=-1),
    "auto": dict(),
}
TIER_VALUES = {
    "sp": dict(value_type="sp"),
    "dp": dict(value_type="dp"),
    "hp": dict(value_type="hp"),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=0.5),
    "sp-rowwise-4": dict(value_type="sp", block_vec_size=4,
                         vector_layout="rowwise"),
    "sp-colwise-4": dict(value_type="sp", block_vec_size=4,
                         vector_layout="colwise"),
}


@pytest.mark.parametrize("values", sorted(TIER_VALUES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tiers_on_card_match_cpu_and_graph_equals_loop(cuda, tier, values):
    """Every tier through SpmvOperator: the card against the plain versions
    on the CPU, the CUDA-graph solve against the loop bit for bit (no
    atomics anywhere), and the fused solve refused."""
    from uspmv_tpu_torch.ops import scs_pieces

    mtx = imbalanced()
    mtx.values[:] = mtx.values / np.bincount(
        mtx.I, weights=np.abs(mtx.values)).max()
    cfg = dict(kernel_format="scs", chunk_size=32, sigma=64,
               **TIERS[tier], **TIER_VALUES[values])
    gpu = SpmvOperator.from_mtx(Config(backend="cuda", **cfg), mtx)
    cpu = SpmvOperator.from_mtx(Config(backend="cpu", **cfg), mtx)
    is_ap = values.startswith("ap")
    want = {"auto": "packed+pieces"}.get(tier, tier)
    if is_ap:  # adaptive precision keeps SELL-C-sigma
        want = want.replace("packed", "scs")
    assert gpu.impl_name() == f"cuda-{want}-{gpu.config.value_type}"
    assert cpu.impl_name() == f"torch-plain-{want}-{gpu.config.value_type}"
    bs = gpu.config.block_vec_size
    x = np.random.default_rng(1).standard_normal(
        (mtx.n_rows, bs) if bs > 1 else mtx.n_rows)
    a = gpu.to_host(gpu.spmv(gpu.make_x(x)))
    b = cpu.to_host(cpu.spmv(cpu.make_x(x)))
    tol = 1e-12 if gpu.working_dtype == torch.float64 else 2e-5
    assert np.abs(a - b).max() <= tol * np.abs(b).max()
    assert not gpu.fused_solve_eligible()
    xd = gpu.make_x(x)
    l_prev, l_fin = gpu.solve(xd, 5, impl="loop")
    for _ in range(2):
        g0 = sum(graph_nodes_replayed().values())
        g_prev, g_fin = gpu.solve(xd, 5, impl="graph")
        assert torch.equal(g_fin, l_fin) and torch.equal(g_prev, l_prev)
    per_spmv = (len(gpu.devs)
                + scs_pieces.KERNELS_PER_LAUNCH * len(gpu.pieces))
    assert sum(graph_nodes_replayed().values()) - g0 == 5 * per_spmv
    with pytest.raises(ValueError, match="fused solve kernel takes"):
        gpu.solve(xd, 5, impl="fused")


# ----------------------------------------- unit stream, x access, cost split


def ones_devs(device):
    """random_banded(5000, 60, 11) at C=128, sigma=32 as an all-ones matrix:
    the unit stream (no values) and the same pattern with explicit ones."""
    from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols

    m = random_banded(5000, 60, 11)
    m.values[:] = 1.0
    scs = convert_to_scs(m.astype(np.float32), 128, 32)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, perm)
    return (build_device_scs(scs, device, unit_values=True),
            build_device_scs(scs, device))


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("layout,bs", SHAPES)
def test_unit_stream_matches_plain_and_repeats_bit_for_bit(cuda, layout, bs,
                                                           accumulate):
    unit, ones = ones_devs(cuda)
    n = unit.n_rows_padded
    shape = (n,) if bs == 1 else (n, bs) if layout == "rowwise" else (bs, n)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(shape, generator=gen).to(cuda)
    y0 = torch.randn(shape, generator=gen).to(cuda)
    before = scs_spmv.launch_counts()[scs_spmv.UNIT_ENTRY]
    got = [spmv_scs(unit, x, layout, y0.clone() if accumulate else None)
           for _ in range(2)]
    torch.cuda.synchronize()
    passes = -(-bs // 8) if layout == "rowwise" else 1
    assert scs_spmv.launch_counts()[scs_spmv.UNIT_ENTRY] == before + 2 * passes
    assert torch.equal(got[0], got[1])
    ref = spmv_scs_plain(unit, x, layout, y0.clone() if accumulate else None)
    err = (got[0] - ref).abs().max().item()
    assert err <= ACC_TOL[torch.float32] * max(ref.abs().max().item(), 1e-30)
    # the same pattern with explicit ones: 1 * x is exact and a padding slot
    # adds 0, so the sums agree to the last bit
    want = spmv_scs(ones, x, layout, y0.clone() if accumulate else None)
    assert torch.equal(got[0], want)


def test_unit_stream_refusals_on_the_card(cuda):
    from uspmv_tpu_torch.ops.scs_solve import solve_scs

    unit, _ = ones_devs(cuda)
    with pytest.raises(TypeError, match="float32 x"):
        spmv_scs(unit, torch.zeros(unit.n_rows_padded, dtype=torch.float64,
                                   device=cuda))
    with pytest.raises(ValueError, match="unit-value"):
        solve_scs(unit, torch.zeros(unit.n_rows_padded, device=cuda), 2)


@pytest.mark.parametrize("out_offset", [0, 1])
@pytest.mark.parametrize("idx_offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4, 1000, 2**20 + 5])
def test_gather_store_exact_at_any_length_and_alignment(cuda, n, idx_offset,
                                                        out_offset):
    """The scalar head and tail and both stores: views at offset 1 are 4 B
    past a 16 B boundary."""
    from uspmv_tpu_torch.ops import x_access

    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(2**21, generator=gen, device=cuda)
    idx = torch.randint(0, x.numel(), (n + idx_offset,), generator=gen,
                        device=cuda, dtype=torch.int32)[idx_offset:]
    out = torch.full((n + out_offset,), float("nan"),
                     device=cuda)[out_offset:]
    before = x_access.launch_counts()[x_access.ENTRIES["gather_store"]]
    got = x_access.gather_store(x, idx, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, x_access.gather_store_plain(x, idx))
    assert (x_access.launch_counts()[x_access.ENTRIES["gather_store"]]
            == before + 1)


@pytest.mark.parametrize("n,n_x", [(1000, 37), (2**20 + 5, 2**21)])
def test_x_access_modes_match_plain(cuda, n, n_x):
    from uspmv_tpu_torch.ops import x_access

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(max(n_x, n), generator=gen, device=cuda)
    v = torch.randn(n, generator=gen, device=cuda)
    idx = torch.randint(0, n_x, (n,), generator=gen, device=cuda,
                        dtype=torch.int32)
    T = x_access.fma_threads(n)
    before = x_access.launch_counts()
    got = x_access.gather_store(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, x_access.gather_store_plain(x, idx))
    tol = x_access.fma_tol(n)
    for name, got, want in (
            ("gather_fma", x_access.gather_fma(x, idx, v),
             x_access.gather_fma_plain(x, idx, v)),
            ("copy_fma", x_access.copy_fma(x, v),
             x_access.copy_fma_plain(x, v))):
        assert got.shape == want.shape == (T,), name
        err = (got - want).abs().max().item()
        assert err <= tol * max(want.abs().max().item(), 1e-30), name
    after = x_access.launch_counts()
    assert all(after[e] == before[e] + 1 for e in x_access.ENTRIES.values())


@pytest.mark.parametrize("variant", ["full", "x_window", "no_store", "no_x",
                                     "bare", "x_row"])
def test_probe_variants_match_plain(cuda, variant):
    from uspmv_tpu_torch.ops import scs_probe

    dev = banded_dev(torch.float32, cuda)
    x = torch.randn(dev.n_rows_padded,
                    generator=torch.Generator().manual_seed(5)).to(cuda)
    name = f"uspmv_scs_probe_{variant}"
    before = scs_probe.launch_counts()[name]
    y, stored = scs_probe.probe_scs(dev, x, variant)  # every row stored
    torch.cuda.synchronize()
    assert scs_probe.launch_counts()[name] == before + 1
    want, want_stored = scs_probe.probe_plain(dev, x, variant)
    assert stored.item() == want_stored.item()
    err = (y - want).abs().max().item()
    assert err <= 1e-5 * max(want.abs().max().item(), 1e-30)
    if variant == "full":
        assert torch.equal(y, spmv_scs(dev, x))
    if variant in scs_probe.THRESHOLDED:
        assert stored.item() == dev.n_rows_padded
        # a threshold in the widest gap between the middle half's sums (so
        # no sum lies near it): the rows above it, and only those
        mid = want.sort().values[want.numel() // 4: 3 * want.numel() // 4]
        i = int(mid.diff().argmax().item())
        thr = (mid[i].item() + mid[i + 1].item()) / 2
        y0 = torch.full_like(y, -7.0)
        y, stored = scs_probe.probe_scs(dev, x, variant, y0.clone(),
                                        store_above=thr)
        want, want_stored = scs_probe.probe_plain(dev, x, variant, y0, thr)
        assert stored.item() == want_stored.item() > 0
        keep = want != -7.0
        assert torch.equal(y[~keep], want[~keep])
        err = (y[keep] - want[keep]).abs().max().item()
        assert err <= 1e-5 * max(want.abs().max().item(), 1e-30)
        # +inf, as timed: nothing stored, nothing counted
        y, stored = scs_probe.probe_scs(dev, x, variant, y0.clone(),
                                        store_above=float("inf"))
        torch.cuda.synchronize()
        assert stored.item() == 0 and torch.equal(y, y0)


# ---------------------- the batched row loop and the persistent packed grid

# rows per trip of the SELL row loop by block width BS (scs_row.cuh:
# kBatchX / BS); the chunk lengths each K needs covered: 0, 1, K-1, K, K+1
# and 2K+3
ROW_TRIP = {1: 8, 2: 4, 4: 2, 8: 1}
CHUNK_LENGTHS = sorted({n for K in ROW_TRIP.values()
                        for n in (0, 1, K - 1, K, K + 1, 2 * K + 3)})


def chunk_length_matrix(C):
    """Rows in blocks of C, block b's rows at most CHUNK_LENGTHS[b % 11]
    long and its first row exactly that long, so that at sigma=1 the
    chunks take every length of CHUNK_LENGTHS (and rows inside a chunk are
    shorter: padding slots)."""
    blocks = max(2 * len(CHUNK_LENGTHS), -(-300 // C))
    n = blocks * C
    rng = np.random.default_rng(C)
    top = np.asarray(CHUNK_LENGTHS)[np.arange(n) // C % len(CHUNK_LENGTHS)]
    counts = np.where(np.arange(n) % C == 0, top,
                      rng.integers(0, top + 1))
    I = np.repeat(np.arange(n), counts)
    J = np.concatenate([rng.choice(n, k, replace=False) for k in counts])
    return MtxData.from_arrays(I, J, rng.standard_normal(I.size), n,
                               n).sort_by_row()


def chunk_devs(mtx, C, sigma, device):
    """The SCS of ``mtx`` with permuted columns, as every pair's DeviceScs
    (values rounded to bf16 where the pair reads bf16, so all pairs hold
    the same numbers) and as the unit stream of its pattern."""
    import dataclasses

    from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols

    scs = convert_to_scs(mtx, C, sigma)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, perm)
    devs = {}
    for vdt, xdt in PAIRS:
        rounded = dataclasses.replace(scs, values=torch.from_numpy(
            scs.values).to(vdt).double().numpy())
        devs[(vdt, xdt)] = build_device_scs(rounded, device, vdt)
    ones = dataclasses.replace(scs, values=(scs.values != 0).astype(
        np.float32))
    devs[(None, torch.float32)] = build_device_scs(ones, device,
                                                   unit_values=True)
    return scs, devs


@pytest.mark.parametrize("sigma", [1, 512])
@pytest.mark.parametrize("C", [1, 3, 32, 1024])
def test_row_loop_trips_match_plain_and_the_solve(cuda, C, sigma):
    """Chunks of 0, 1, K-1, K, K+1 and 2K+3 elements for every trip K of
    the row loop: every pair and the unit stream, rowwise bs 1-8 and
    colwise, written and accumulated, against the plain version; twice in
    a row bit-equal; and the fused solve at k=1 bit-equal to the SpMV."""
    from uspmv_tpu_torch.ops import scs_solve

    scs, devs = chunk_devs(chunk_length_matrix(C), C, sigma, cuda)
    if sigma == 1:
        assert set(CHUNK_LENGTHS) <= set(scs.chunk_lengths.tolist())
    n = scs.n_rows_padded
    shapes = [("rowwise", bs) for bs in range(1, 9)] + [("colwise", 3)]
    for (vdt, xdt), dev in devs.items():
        for layout, bs in shapes:
            shape = block_shape(n, layout, bs)
            x, y0 = randn_pair(shape, xdt, cuda, bs)
            for accumulate in (False, True):
                what = f"{vdt} {xdt} {layout} bs={bs} acc={accumulate}"
                got = [spmv_scs(dev, x, layout,
                                y0.clone() if accumulate else None)
                       for _ in range(2)]
                torch.cuda.synchronize()
                assert torch.equal(got[0], got[1]), what
                ref = spmv_scs_plain(dev, x, layout,
                                     y0.clone() if accumulate else None)
                err = (got[0] - ref).abs().max().item()
                assert err <= ACC_TOL[xdt] * max(ref.abs().max().item(),
                                                 1e-30), what
            if (vdt, xdt) in SOLVE_PAIRS and layout == "rowwise":
                prev, fin = scs_solve.solve_scs(dev, x, 1)
                assert torch.equal(prev, x), what
                assert torch.equal(fin, spmv_scs(dev, x)), what


def packed_matrix(n, seed):
    """Rows 0-127 of exactly 32 elements (one group of GROUP_MAX_ELEMS),
    rows 200-459 empty (a whole group), the rest of 0 to 8 elements or,
    one in twenty, of 32; no column twice in a row."""
    rng = np.random.default_rng(seed)
    counts = np.where(rng.random(n) < 0.05, 32, rng.integers(0, 9, n))
    counts[:128] = 32
    counts[200:460] = 0
    I = np.repeat(np.arange(n), counts)
    j = np.arange(I.size) - np.repeat(np.cumsum(counts) - counts, counts)
    J = (rng.integers(0, n, I.size) // 33 * 33 + j) % n  # distinct in a row
    return MtxData.from_arrays(I, J, rng.standard_normal(I.size), n,
                               n).sort_by_row()


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 3),
                                       ("colwise", 2)])
@pytest.mark.parametrize("n", [2000, 400_000])
@pytest.mark.parametrize("pair", PACKED_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_packed_grid_matches_plain_and_repeats_bit_for_bit(cuda, pair, n,
                                                           layout, bs):
    """The persistent grid with fewer groups than SMs (n=2000) and more
    groups than it holds (n=400,000), a group of exactly GROUP_MAX_ELEMS
    elements, rows of 0 and 32 elements; dp, sp, hp, rowwise and colwise."""
    from uspmv_tpu_torch.formats.scs import convert_to_scs, permute_scs_cols
    from uspmv_tpu_torch.ops import scs_packed
    from uspmv_tpu_torch.ops.device_format import (
        GROUP_MAX_ELEMS,
        build_device_packed,
    )

    vdt, xdt = pair
    mtx = packed_matrix(n, seed=n)
    mtx.values = torch.from_numpy(mtx.values).to(vdt).double().numpy()
    scs = convert_to_scs(mtx, 32, 1)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, perm)
    dev = build_device_packed(scs, cuda, vdt)
    assert dev.max_group_elems == GROUP_MAX_ELEMS
    counts = np.diff(dev.row_ptr.cpu().numpy())
    assert counts.min() == 0 and counts.max() == 32
    n_vec = bs if layout == "colwise" else 1
    geom = scs_packed.launch_geometry(dev, xdt, n_vec)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert geom["stage_bytes"] == GROUP_MAX_ELEMS * xdt.itemsize
    assert geom["blocks_per_sm"] >= 1
    if n == 2000:
        assert geom["grid"] == dev.n_groups < sms
    else:
        assert geom["grid"] < dev.n_groups
    shape = block_shape(dev.n_rows_padded, layout, bs)
    x, y0 = randn_pair(shape, xdt, cuda, n)
    name = scs_packed.entry_point(vdt, xdt)
    for accumulate in (False, True):
        before = scs_packed.launch_counts()[name]
        got = [scs_packed.spmv_packed(dev, x, layout,
                                      y0.clone() if accumulate else None)
               for _ in range(2)]
        torch.cuda.synchronize()
        assert scs_packed.launch_counts()[name] == before + 2
        assert torch.equal(got[0], got[1])
        ref = scs_packed.spmv_packed_plain(dev, x, layout,
                                           y0.clone() if accumulate else None)
        err = (got[0] - ref).abs().max().item()
        assert err <= ACC_TOL[xdt] * max(ref.abs().max().item(), 1e-30)


def test_launch_geometry_of_the_sell_kernel(cuda):
    """Every entry's one-vector kernel keeps at least kMinBlocksPerSm (5)
    blocks resident and launches a block per 256 padded rows."""
    dev = banded_dev(torch.float32, cuda)
    for (vdt, xdt), entry in scs_spmv._ENTRY_POINTS.items():
        geom = scs_spmv.launch_geometry(banded_dev(vdt, cuda), xdt)
        assert geom["blocks_per_sm"] >= 5, entry
        assert geom["grid"] == -(-dev.n_rows_padded // 256)
    unit, _ = ones_devs(cuda)
    assert scs_spmv.launch_geometry(unit, torch.float32)["blocks_per_sm"] >= 5


# ------------------------------------------------- row-sharded execution


def sharded(mtx, device, **kw):
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    cfg = dict(kernel_format="scs", chunk_size=32, sigma=1, value_type="sp",
               n_shards=4, backend="cpu" if device.type == "cpu" else "cuda")
    cfg.update(kw)
    return DistributedSpmvOperator.from_mtx(Config(**cfg), mtx)


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 4),
                                       ("colwise", 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_exchange_bit_equal_to_plain(cuda, dtype, layout, bs):
    from uspmv_tpu_torch.ops import halo_exchange as hx

    op = sharded(laplace2d(64), cuda, block_vec_size=bs, vector_layout=layout,
                 seg_method="seg-nnz")
    ex = op.exchanges["sp"]
    assert ex.n == op.comm_volume_per_spmv()["sp"]["real"] > 0
    gen = torch.Generator(device=cuda).manual_seed(bs)
    x = torch.randn(op.x_shape(), generator=gen, device=cuda).to(dtype)
    name = hx._ENTRY_POINTS[dtype]
    before = hx.launch_counts()[name]
    got = hx.halo_exchange(ex, x.clone(), layout)
    torch.cuda.synchronize()
    assert hx.launch_counts()[name] == before + 1
    assert torch.equal(got, hx.halo_exchange_plain(ex, x.clone(), layout))
    assert not torch.equal(got, x)


SHARDED_CASES = {
    "sp-overlap": dict(),
    "sp-no-overlap": dict(overlap_comm=False),
    "dp-seg-metis": dict(value_type="dp", seg_method="seg-metis"),
    "sp-allgather": dict(comm_mode="allgather"),
    "sp-rowwise-4": dict(block_vec_size=4, vector_layout="rowwise"),
    "sp-colwise-4": dict(block_vec_size=4, vector_layout="colwise"),
    "ap[dp_sp]": dict(value_type="ap[dp_sp]", ap_threshold_1=2.0),
    "hp": dict(value_type="hp"),
    "sp-pieces-packed": dict(matrix="imbalanced", seg_method="seg-nnz",
                             split_rows_threshold=8),
}


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_operator_matches_single_device(cuda, case):
    kw = dict(SHARDED_CASES[case])
    mtx = imbalanced() if kw.pop("matrix", None) else laplace2d(64)
    op = sharded(mtx, cuda, **kw)
    cpu = sharded(mtx, torch.device("cpu"), **kw)
    single_kw = {k: v for k, v in kw.items()
                 if k not in ("seg_method", "comm_mode", "overlap_comm")}
    single = SpmvOperator.from_mtx(Config(
        kernel_format="scs", chunk_size=32, sigma=1, backend="cuda",
        **dict(dict(value_type="sp"), **single_kw)), mtx)
    bs = kw.get("block_vec_size", 1)
    x = np.random.default_rng(5).standard_normal(
        (mtx.n_rows, bs) if bs > 1 else mtx.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    want = single.to_host(single.spmv(single.make_x(x)))
    tol = TOL["dp"] if op.config.value_type == "dp" else TOL["sp"]
    scale = np.abs(want).max()
    assert np.abs(y - want).max() <= tol * scale * 4
    assert np.abs(y - cpu.to_host(cpu.spmv(cpu.make_x(x)))).max() <= \
        tol * scale * 4
    assert op.impl_name().startswith("cuda-dist4-")
    # twice the same bits: the exchange and the kernels are deterministic
    assert np.array_equal(op.to_host(op.spmv(op.make_x(x))), y)


@pytest.mark.parametrize("case", ["sp-overlap", "sp-no-overlap",
                                  "ap[dp_sp]", "sp-colwise-4",
                                  "sp-pieces-packed"])
def test_sharded_graph_solve_equals_loop(cuda, case):
    from uspmv_tpu_torch.ops import halo_exchange as hx

    kw = dict(SHARDED_CASES[case])
    mtx = imbalanced() if kw.pop("matrix", None) else laplace2d(64)
    # row sums of |A| <= 1: the iterates stay finite
    mtx.values[:] = mtx.values / np.bincount(
        mtx.I, weights=np.abs(mtx.values)).max()
    op = sharded(mtx, cuda, **kw)
    x = op.make_x()
    assert op.solve_impl_name(5) == "graph"
    loop = op.solve(x.clone(), 5, impl="loop")
    n0 = sum(hx.launch_counts().values())
    graph = op.solve(x.clone(), 5)
    again = op.solve(x.clone(), 5)
    torch.cuda.synchronize()
    for a, b, c in zip(loop, graph, again):
        assert np.array_equal(op.to_host(a), op.to_host(b))
        assert np.array_equal(op.to_host(b), op.to_host(c))
    # the capture's warm-up launched the exchange once per precision with
    # a plan; the replays launched nothing through the wrapper
    n_ex = sum(1 for e in op.exchanges.values() if e is not None and e.n)
    assert sum(hx.launch_counts().values()) - n0 == n_ex


def test_sharded_backend_cuda_without_a_gpu_raises(cuda, monkeypatch):
    from uspmv_tpu_torch.runtime.operator import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        sharded(laplace2d(16), cuda)


# ------------------------------------------------ slice 10: the auxiliaries

@pytest.mark.parametrize("value_type", ["sp", "hp"])
def test_bcoo_matches_the_kernel_path(cuda, value_type):
    from uspmv_tpu_torch.ops.spmv_bcoo import BcooSpmvOperator

    mtx = random_banded(20_000, 40, 9)
    kw = dict(kernel_format="scs", chunk_size=32, sigma=64,
              value_type=value_type, backend="cuda")
    op = SpmvOperator.from_mtx(Config(**kw), mtx)
    bop = BcooSpmvOperator.from_mtx(Config(impl="bcoo", **kw), mtx)
    assert bop.impl_name() == f"cusparse-csr-{value_type}"
    assert bop.devs[value_type].mat.device.type == "cuda"
    x = np.random.default_rng(6).standard_normal(mtx.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    yb = bop.to_host(bop.spmv(bop.make_x(x)))
    # the same stored values (hp: bf16-rounded, widened), f32 sums
    assert np.abs(yb - y).max() <= 1e-5 * np.abs(y).max()
    _, ys = bop.solve(bop.make_x(x * 0.01), 3)
    assert torch.isfinite(ys).all()


def test_xla_route_runs_the_plain_path_on_the_card(cuda):
    mtx = laplace2d(120)
    kw = dict(kernel_format="scs", chunk_size=32, sigma=1, value_type="sp",
              backend="cuda")
    op = SpmvOperator.from_mtx(Config(impl="xla", **kw), mtx)
    ref = SpmvOperator.from_mtx(Config(**kw), mtx)
    assert op.impl_name() == "torch-plain-scs-sp"
    assert ref.impl_name() == "cuda-scs-sp"
    x = op.make_x(np.random.default_rng(7).standard_normal(mtx.n_rows))
    assert x.device.type == "cuda"
    n0 = launch_count()
    y = op.spmv(x)
    torch.cuda.synchronize()
    assert launch_count() == n0  # no kernel of this package launched
    y_ref = ref.spmv(x)
    assert (y - y_ref).abs().max().item() <= 1e-5 * y_ref.abs().max().item()
    # solve: the default on the card is one CUDA graph of the plain ops
    assert op.solve_impl_name(4) == "graph"
    xs = x * 0.1
    _, y_graph = op.solve(xs, 4)
    _, y_loop = op.solve(xs, 4, impl="loop")
    assert (y_graph - y_loop).abs().max().item() <= \
        1e-5 * y_loop.abs().max().item()


def test_log_prof_trace_names_the_sell_kernel(cuda, tmp_path, capsys):
    import json

    from uspmv_tpu_torch import cli
    from uspmv_tpu_torch.runtime import profiling

    rc = cli.main(["Laplace3D,32", "scs", "-c", "1024", "-s", "1", "-sp",
                   "-mixed_tiles", "0", "-mode", "b", "-bench_time", "0.01",
                   "-log_prof", str(tmp_path / "prof"),
                   "-mtx_out", str(tmp_path)])
    assert rc == 0
    path = profiling.last_trace_path()
    assert path.startswith(str(tmp_path / "prof"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "spmv_scs_benchmark" for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert any("scs_spmv_kernel" in e.get("name", "") for e in kernels)


def test_hubbard_through_the_default_tiers_matches_scipy(cuda):
    from uspmv_tpu_torch.io.generators import generate_matrix
    from uspmv_tpu_torch.ops import scs_packed, scs_pieces

    mtx = generate_matrix("Hubbard,n_sites=8,n_fermions=4,U=1.3")
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=1024, sigma=1,
               value_type="sp", backend="cuda"), mtx)
    assert op.impl_name().startswith("cuda-")
    x = np.random.default_rng(8).standard_normal(mtx.n_rows)
    n0 = (launch_count() + scs_packed.launch_count()
          + scs_pieces.launch_count())
    y = op.to_host(op.spmv(op.make_x(x)))
    torch.cuda.synchronize()
    assert (launch_count() + scs_packed.launch_count()
            + scs_pieces.launch_count()) > n0
    ref = mtx.to_scipy().tocsr() @ x.astype(np.float32).astype(np.float64)
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()
