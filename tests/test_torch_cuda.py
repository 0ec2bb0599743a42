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
from uspmv_tpu_torch.ops.device_format import (
    build_device_scs,
    vector_pass_count,
)
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
    passes = vector_pass_count(bs) if layout == "rowwise" else 1
    assert scs_spmv.launch_counts()[name] == before + passes
    ref = spmv_scs_plain(dev, x, layout, y0.clone() if accumulate else None)
    assert y.dtype == xdt and y.shape == ref.shape == shape
    err = (y - ref).abs().max().item()
    assert err <= ACC_TOL[xdt] * max(ref.abs().max().item(), 1e-30)


def offset_copy(t):
    """``t`` as a contiguous view one element into a buffer of its own: its
    rows miss 16-byte boundaries, so the kernels read them by scalar
    loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape).copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("bs", [4, 6, 8, 10, 12, 16])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_rowwise_16_byte_x_loads_equal_scalar_loads(cuda, pair, bs,
                                                    accumulate):
    """Rowwise x whose rows lie on 16-byte boundaries (bs 4, 8, 12, 16;
    passes of 8 then 4 or 8 at a column offset) are read by 16-byte loads
    (a pass of 8 doubles keeps scalar loads), the same x one element into
    its buffer by the scalar loads of the parent design, and bs 6 and 10
    never on 16-byte rows: the same bits, and those of one launch per
    column; within tolerance of the plain version."""
    vdt, xdt = pair
    dev = banded_dev(vdt, cuda)
    n = dev.n_rows_padded
    x, y0 = randn_pair((n, bs), xdt, cuda, bs)
    init = y0.clone() if accumulate else None
    y = spmv_scs(dev, x, "rowwise", init)
    scalar = spmv_scs(dev, offset_copy(x), "rowwise",
                      None if init is None else y0.clone())
    torch.cuda.synchronize()
    assert torch.equal(y, scalar)
    ones = torch.stack([
        spmv_scs(dev, x[:, v].contiguous(),
                 y=None if init is None else y0[:, v].contiguous())
        for v in range(bs)], dim=1)
    assert torch.equal(y, ones)
    ref = spmv_scs_plain(dev, x, "rowwise",
                         None if init is None else y0.clone())
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


@pytest.mark.parametrize("k", [1, 2, 7])
@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("pair", SOLVE_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_fused_solve_16_byte_loads_equal_scalar_loads(cuda, pair, bs, k):
    """The fused solve with x0 on 16-byte rows (bs 4: 16-byte plain loads
    of x0 and its buffers; bs 8 keeps scalar loads) and one element into
    its buffer (scalar loads): the same bits, and those of k launches of
    the SpMV kernel."""
    from uspmv_tpu_torch.ops import scs_solve

    vdt, xdt = pair
    dev = contraction(banded_dev(vdt, cuda))
    x, _ = randn_pair((dev.n_rows_padded, bs), xdt, cuda, k)
    prev, fin = scs_solve.solve_scs(dev, x, k)
    s_prev, s_fin = scs_solve.solve_scs(dev, offset_copy(x), k)
    torch.cuda.synchronize()
    assert torch.equal(fin, s_fin) and torch.equal(prev, s_prev)
    want = x
    for _ in range(k):
        want = spmv_scs(dev, want)
    assert torch.equal(fin, want)


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
    per_iter = len(op.devs) * (vector_pass_count(bs)
                               if op.config.vector_layout == "rowwise"
                               else 1)
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


def check_pieces(pieces, x, y0, layout, strided=False):
    """spmv_pieces twice against its plain version: one launch each, the
    same bits, the counters back at 0, the rows of no parent untouched;
    block vectors: each vector bit-equal to a one-vector launch.
    ``strided``: colwise x and y as views with a stride of their own."""
    from uspmv_tpu_torch.ops import scs_pieces

    name = scs_pieces.entry_point(pieces.values.dtype, x.dtype)
    before = scs_pieces.launch_counts()[name]

    def block(t):
        return strided_view(t, 41)[0] if strided else t.clone()

    y = scs_pieces.spmv_pieces(pieces, block(x), layout, block(y0))
    again = scs_pieces.spmv_pieces(pieces, block(x), layout, block(y0))
    torch.cuda.synchronize()
    assert scs_pieces.launch_counts()[name] == before + 2
    assert torch.equal(y, again)  # no float atomics: the same bits every run
    assert not pieces.arrivals.any() and not pieces.slots.any()
    if x.dim() == 2:
        cols = layout == "rowwise"
        ones = [scs_pieces.spmv_pieces(
            pieces, (x[:, v] if cols else x[v]).contiguous(), "rowwise",
            (y0[:, v] if cols else y0[v]).clone())
            for v in range(x.shape[1] if cols else x.shape[0])]
        assert torch.equal(y, torch.stack(ones, dim=1 if cols else 0))
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


# (layout, bs, form): one vector; rowwise blocks whose rows lie on 16-byte
# boundaries (bs 4, 8, 16) or not (bs 2, 3, 9; "offset": bs 8 at an odd
# element offset); colwise blocks, contiguous or "strided" views. bs 2, 3
# and 9 leave their last pass guarded, 16 takes two passes of 8.
PIECES_SHAPES = (
    [("rowwise", 1, "")]
    + [(layout, bs, "") for layout in ("rowwise", "colwise")
       for bs in (2, 3, 4, 8, 9, 16)]
    + [("rowwise", 8, "offset"), ("colwise", 8, "strided"),
       ("colwise", 9, "strided")])


def pieces_shape_id(shape):
    layout, bs, form = shape
    return f"{layout}-{bs}" + (f"-{form}" if form else "")


def pieces_block(pieces, shape, xdt, device, seed):
    """x and y0 of ``shape`` for ``pieces``; "offset": x a contiguous view
    one element into its buffer, so its rows miss 16-byte boundaries."""
    layout, bs, form = shape
    x, y0 = randn_pair(block_shape(pieces.n_rows_padded, layout, bs), xdt,
                       device, seed)
    if form == "offset":
        x = offset_copy(x)
    return x, y0


@pytest.mark.parametrize("th", [2, 32, 1024])
@pytest.mark.parametrize("shape", PIECES_SHAPES, ids=pieces_shape_id)
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_pieces_match_plain_and_repeat_bit_for_bit(cuda, pair, shape, th):
    """One launch reads the pieces once per pass of 8 vectors; each
    vector bit-equal to a one-vector launch, within tolerance of the plain
    version, slots and counters back at 0."""
    vdt, xdt = pair
    layout, bs, form = shape
    _, pieces = split_streams(imbalanced(), th, 32, 64, vdt, xdt, bs, cuda)
    assert pieces.n_pieces >= (1500 if th == 2 else 2)
    x, y0 = pieces_block(pieces, shape, xdt, cuda, th)
    check_pieces(pieces, x, y0, layout, strided=form == "strided")


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


@pytest.mark.parametrize("shape", PIECES_SHAPES, ids=pieces_shape_id)
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_pieces_short_and_long_parents(cuda, pair, shape):
    """Parents of 1, 7, 8 (short: one record, up to full), 9 (two records),
    32, 33 and 300 pieces (a fold of 300 slots)."""
    from uspmv_tpu_torch.ops.device_format import RECORD_PIECES as R

    vdt, xdt = pair
    layout, bs, form = shape
    runs = [1, R - 1, R, R + 1, 32, 33, 300]
    _, pieces = split_streams(parents_of(runs), 4, 32, 8, vdt, xdt, bs, cuda)
    got = np.diff(pieces.parent_ptr.cpu().numpy())
    assert sorted(got[got > 1]) == sorted(p for p in runs if p > 1)
    assert pieces.longs.shape[0] == sum(p > R for p in runs)
    x, y0 = pieces_block(pieces, shape, xdt, cuda, bs)
    check_pieces(pieces, x, y0, layout, strided=form == "strided")


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("colwise", 8)])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_pieces_graph_replays_equal_the_launch(cuda, pair, layout, bs):
    """Two replays of one captured graph give the launch's bits: the last
    record of each long parent resets its counter (colwise bs=8: the
    pass's counter, once for all 8 vectors)."""
    from uspmv_tpu_torch.ops import scs_pieces

    vdt, xdt = pair
    _, pieces = split_streams(imbalanced(), 2, 32, 64, vdt, xdt, bs, cuda)
    assert pieces.longs.shape[0] > 0
    x, y0 = randn_pair(block_shape(pieces.n_rows_padded, layout, bs), xdt,
                       cuda, 5)
    want = scs_pieces.spmv_pieces(pieces, x, layout, y0.clone())
    y = y0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a warm-up outside the capture
        scs_pieces.spmv_pieces(pieces, x, layout, y0.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with scs_spmv.record_captured_launches() as nodes:
        with torch.cuda.graph(graph):
            scs_pieces.spmv_pieces(pieces, x, layout, y)
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
    passes = vector_pass_count(bs) if layout == "rowwise" else 1
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
    """Every entry's one-vector kernel and its kernel of 8 colwise vectors
    keep at least kMinBlocksPerSm (5) blocks resident, in the form with
    group lengths and in the chunk form (the same matrix without them),
    and launch a block per 256 padded rows by a grid row per pass of 8
    vectors; no colwise instantiation spills to local memory."""
    import dataclasses

    from uspmv_tpu_torch.ops import _build

    for (vdt, xdt), entry in scs_spmv._ENTRY_POINTS.items():
        dev = banded_dev(vdt, cuda)
        chunks = dataclasses.replace(dev, group_lengths=dev.group_lengths[:0])
        for form, d in ((1, dev), (0, chunks)):
            for n_vec, passes in ((1, 1), (8, 1), (16, 2), (17, 3)):
                geom = scs_spmv.launch_geometry(d, xdt, n_vec)
                assert geom["groups"] == form, entry
                assert geom["blocks_per_sm"] >= 5, (entry, form, n_vec)
                assert geom["grid"] == -(-dev.n_rows_padded // 256)
                assert geom["passes"] == passes
    unit, _ = ones_devs(cuda)
    for n_vec in (1, 8):
        assert scs_spmv.launch_geometry(
            unit, torch.float32, n_vec)["blocks_per_sm"] >= 5
    colwise, vec_x = [], []
    for r in _build.kernel_resources(_build.load_library().path):
        # (kernel, template arguments, index of kColwise)
        for kernel, n_args, at in (("scs_spmv_kernel<", 8, 6),
                                   ("scs_ones_kernel<", 4, 3)):
            if kernel in r["function"]:
                args = r["function"].split(kernel)[1].split(">")[0]
                args = [a.strip() for a in args.split(",")]
                assert len(args) == n_args, r["function"]
                if args[at] == "true":
                    colwise.append(r)
                if kernel == "scs_spmv_kernel<" and args[-1] == "true":
                    vec_x.append(r)
    # every (values, x) pair and the unit stream, BS 2, 4 (full, guarded)
    # and 8 (full, guarded), with and without group lengths
    assert len(colwise) == 5 * 5 * 2 + 5
    # rowwise BS 4 by 16-byte x loads for every pair, BS 8 for f32 x (8
    # doubles spilled), both loop forms
    assert len(vec_x) == (5 + 2) * 2
    assert all(r["local"] == 0 and r["registers"] <= 48
               for r in colwise + vec_x), colwise + vec_x


def pieces_block_shape(pair, n_vec):
    """(threads per block, blocks per SM at least) of the pieces kernel
    for ``n_vec`` vectors of a (values, x) pair: the one-vector kernel's
    256 threads at up to 128 registers (98-123 on sm_90a) keep 2 blocks;
    the block-vector kernels' __launch_bounds__ (csrc/scs_pieces.cu
    BlockShape): f32 values and x 256 threads, 2 blocks, the other pairs
    128 threads, 3 blocks."""
    if n_vec == 1 or pair == (torch.float32, torch.float32):
        return 256, 2
    return 128, 3


def test_launch_geometry_of_the_pieces_kernel(cuda):
    """The pieces kernel's instantiations keep their blocks per SM: every
    (values, x) pair at one vector and at 8 and 16 vectors (a grid row per
    pass of 8, all resident blocks shared among them), by 16-byte and by
    scalar x loads; none spills to local memory."""
    from uspmv_tpu_torch.ops import _build, scs_pieces

    for vdt, xdt in PAIRS:
        _, pieces = split_streams(imbalanced(), 2, 32, 64, vdt, xdt, 16, cuda)
        for n_vec, passes in ((1, 1), (8, 1), (16, 2)):
            for vec_x in (False, True):
                geom = scs_pieces.launch_geometry(pieces, xdt, n_vec, vec_x)
                threads, blocks = pieces_block_shape((vdt, xdt), n_vec)
                assert geom["passes"] == passes
                assert geom["threads_per_block"] == threads
                assert geom["blocks_per_sm"] >= blocks, (vdt, xdt, n_vec,
                                                         vec_x, geom)
                warps = geom["threads_per_block"] // 32
                assert 1 <= geom["grid"] <= -(-pieces.records.shape[0]
                                              // warps)
    kernels = [r for r in _build.kernel_resources(
        _build.load_library().path) if "scs_pieces_" in r["function"]]
    # per pair: the one-vector kernel; 4 and 8, each full and full by
    # 16-byte loads; 8 guarded
    assert len(kernels) == 6 * 5
    assert all(r["local"] == 0 and r["stack"] == 0 for r in kernels), [
        r for r in kernels if r["local"] or r["stack"]]


def colwise_stream(name, device):
    """(DeviceScs, x dtype) of stream ``name``: path E's padded dp stream
    (WideSpectrum-8 at C=32) as a (values, x) pair read by its group lengths
    ("groups") or by its chunks' ("chunks"), or the unit stream."""
    import dataclasses

    if name == "unit":
        return ones_devs(device)[0], torch.float32
    pair_name, form = name.rsplit("-", 1)
    pair = next(p for p in PAIRS if f"{p[0]}-{p[1]}" == pair_name)
    dev = pair_dev(padded_streams(32, 1)["dp"], pair, device)
    assert dev.group_length_bytes
    if form == "chunks":
        dev = dataclasses.replace(dev, group_lengths=dev.group_lengths[:0])
    return dev, pair[1]


def strided_view(t, pad):
    """``t`` [bs, n] as a view into a wider buffer filled with NaN: each
    vector contiguous, ``pad`` elements between them (a shard's part of a
    sharded operator's x). Returns (view, buffer)."""
    bs, n = t.shape
    buf = torch.full((bs, n + pad), float("nan"), dtype=t.dtype,
                     device=t.device)
    view = buf[:, 3:3 + n]
    view.copy_(t)
    return view, buf


COLWISE_STREAMS = [f"{v}-{x}-{form}" for v, x in PAIRS
                   for form in ("groups", "chunks")] + ["unit"]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("bs", [2, 3, 8, 9, 16])
@pytest.mark.parametrize("stream", COLWISE_STREAMS)
def test_colwise_block_equals_one_vector_launches(cuda, stream, bs, strided):
    """bs colwise vectors in one launch (a pass of 8 vectors per grid row)
    are bs one-vector launches and the rowwise form's columns, bit for
    bit, written and accumulated, on contiguous vectors and on views with
    a stride of their own; within tolerance of the plain version; nothing
    outside the views written."""
    dev, xdt = colwise_stream(stream, cuda)
    n = dev.n_rows_padded
    x, y0 = randn_pair((bs, n), xdt, cuda, bs)
    if strided:
        x, _ = strided_view(x, 41)
    name = scs_spmv.entry_for(dev, xdt)
    for accumulate in (False, True):
        what = f"{stream} bs={bs} strided={strided} acc={accumulate}"
        out, buf = strided_view(y0, 23) if strided else (y0.clone(), None)
        before = scs_spmv.launch_counts()[name]
        if accumulate:
            y = spmv_scs(dev, x, "colwise", y=out)
        else:
            y = spmv_scs(dev, x, "colwise", out=out)
        torch.cuda.synchronize()
        assert scs_spmv.launch_counts()[name] == before + 1, what
        assert y.data_ptr() == out.data_ptr(), what
        init = y0 if accumulate else None
        ones = torch.stack([
            spmv_scs(dev, x[v].contiguous(),
                     y=None if init is None else init[v].clone())
            for v in range(bs)])
        assert torch.equal(y, ones), what
        rows = spmv_scs(dev, x.t().contiguous(), "rowwise",
                        None if init is None else init.t().contiguous())
        assert torch.equal(y, rows.t()), what
        ref = spmv_scs_plain(dev, x.contiguous(), "colwise",
                             None if init is None else init.clone())
        err = (y - ref).abs().max().item()
        assert err <= ACC_TOL[xdt] * max(ref.abs().max().item(), 1e-30), what
        if buf is not None:
            assert buf[:, :3].isnan().all() and buf[:, 3 + n:].isnan().all()


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("bs", [2, 3, 8, 9, 16])
@pytest.mark.parametrize("pair", PACKED_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_packed_colwise_equals_one_vector_launches(cuda, pair, bs, strided):
    """The packed kernel's colwise vectors, one launch that reads each
    group once for all of them, against one launch per vector and the
    rowwise form's columns bit for bit, written and accumulated, on
    contiguous vectors and strided views; its grid is the one-vector
    grid."""
    from uspmv_tpu_torch.ops import scs_packed

    vdt, xdt = pair
    dev, _ = split_streams(imbalanced(), 32, 32, 64, vdt, xdt, 1, cuda,
                           packed=True)
    n = dev.n_rows_padded
    assert scs_packed.launch_geometry(dev, xdt, bs)["grid"] == \
        scs_packed.launch_geometry(dev, xdt)["grid"]
    x, y0 = randn_pair((bs, n), xdt, cuda, bs)
    if strided:
        x, _ = strided_view(x, 41)
    for accumulate in (False, True):
        what = f"{pair} bs={bs} strided={strided} acc={accumulate}"
        out, buf = strided_view(y0, 23) if strided else (y0.clone(), None)
        if accumulate:
            y = scs_packed.spmv_packed(dev, x, "colwise", y=out)
        else:
            y = scs_packed.spmv_packed(dev, x, "colwise", out=out)
        torch.cuda.synchronize()
        init = y0 if accumulate else None
        ones = torch.stack([
            scs_packed.spmv_packed(dev, x[v].contiguous(),
                                   y=None if init is None else init[v].clone())
            for v in range(bs)])
        assert torch.equal(y, ones), what
        rows = scs_packed.spmv_packed(
            dev, x.t().contiguous(), "rowwise",
            None if init is None else init.t().contiguous())
        assert torch.equal(y, rows.t()), what
        ref = scs_packed.spmv_packed_plain(dev, x.contiguous(), "colwise",
                                           None if init is None
                                           else init.clone())
        err = (y - ref).abs().max().item()
        assert err <= ACC_TOL[xdt] * max(ref.abs().max().item(), 1e-30), what
        if buf is not None:
            assert buf[:, :3].isnan().all() and buf[:, 3 + n:].isnan().all()


# ---------------------------------------- group lengths of the row loop


def padded_streams(C, sigma):
    """WideSpectrum-8's three adaptive-precision streams (ap[dp_sp_hp]
    -dp_emu, thresholds 1e-2 / 1e-5, as path E) at (C, sigma), host
    ScsData with permuted columns: rows of very different lengths share
    a chunk, so padding lies below and past the groups' lengths."""
    cfg = Config(kernel_format="scs", chunk_size=C, sigma=sigma,
                 value_type="ap[dp_sp_hp]", dp_emulation=True,
                 ap_threshold_1=1e-2, ap_threshold_2=1e-5, backend="cpu")
    from uspmv_tpu_torch.io.generators import wide_spectrum

    return SpmvOperator.from_mtx(cfg, wide_spectrum(8)).scs


def pair_dev(scs, pair, device):
    """``scs`` as the DeviceScs of a (values, x) pair, values rounded to
    the pair's value dtype on the host."""
    import dataclasses

    vdt, _ = pair
    rounded = dataclasses.replace(scs, values=torch.from_numpy(
        scs.values.astype(np.float64)).to(vdt).double().numpy())
    return build_device_scs(rounded, device, vdt)


@pytest.mark.parametrize("C,sigma", [(32, 1), (1024, 1), (128, 8)])
@pytest.mark.parametrize("stream", ["dp", "sp", "hp"])
def test_padded_streams_match_plain(cuda, stream, C, sigma):
    """Every instantiation on a stream whose groups are shorter than their
    chunks: rowwise bs 1-8 and colwise, written and accumulated, against
    the plain version, and twice in a row bit-equal."""
    scs = padded_streams(C, sigma)[stream]
    n = scs.n_rows_padded
    for pair in PAIRS:
        dev = pair_dev(scs, pair, cuda)
        assert dev.nnz < dev.n_read < dev.n_elements
        for layout, bs in SHAPES:
            x, y0 = randn_pair(block_shape(n, layout, bs), pair[1], cuda, bs)
            for accumulate in (False, True):
                what = f"{pair} {layout} bs={bs} acc={accumulate}"
                got = [spmv_scs(dev, x, layout,
                                y0.clone() if accumulate else None)
                       for _ in range(2)]
                torch.cuda.synchronize()
                assert torch.equal(got[0], got[1]), what
                ref = spmv_scs_plain(dev, x, layout,
                                     y0.clone() if accumulate else None)
                err = (got[0] - ref).abs().max().item()
                assert err <= ACC_TOL[pair[1]] * max(
                    ref.abs().max().item(), 1e-30), what


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("bs", [1, 4])
@pytest.mark.parametrize("stream", ["dp", "sp", "hp"])
def test_padded_fused_solve_equals_k_launches(cuda, stream, bs, k):
    """The fused solve shares the row loop: on a padded stream it equals
    k launches of the SpMV kernel bit for bit, for its three pairs."""
    from uspmv_tpu_torch.ops import scs_solve

    scs = padded_streams(32, 1)[stream]
    n = scs.n_rows_padded
    for pair in SOLVE_PAIRS:
        dev = contraction(pair_dev(scs, pair, cuda))
        x, _ = randn_pair((n,) if bs == 1 else (n, bs), pair[1], cuda, k)
        prev, fin = scs_solve.solve_scs(dev, x, k)
        want_prev, want = x, x
        for _ in range(k):
            want_prev, want = want, spmv_scs(dev, want)
        torch.cuda.synchronize()
        assert torch.equal(fin, want) and torch.equal(prev, want_prev), pair


def uses_and_group_lengths(scs):
    """Per permuted row: whether a stored element reads column
    perm[0] (where the padding's column 0 went), its count, and its
    group's length (groups of GROUP_ROWS rows within a chunk)."""
    from uspmv_tpu_torch.ops.device_format import GROUP_ROWS

    C, counts = scs.C, scs.row_counts_new.astype(np.int64)
    pad_col = int(scs.old_to_new_idx[0])
    real = ~scs.padding_mask()
    rows = scs.flat_row_idx()
    uses = np.zeros(scs.n_rows_padded, dtype=bool)
    uses[rows[real & (scs.col_idxs == pad_col)]] = True
    per = counts.reshape(-1, C)
    groups = [per[:, g:g + GROUP_ROWS].max(axis=1, keepdims=True)
              .repeat(min(GROUP_ROWS, C - g), axis=1)
              for g in range(0, C, GROUP_ROWS)]
    group_len = np.concatenate(groups, axis=1).ravel()
    return pad_col, uses, counts, group_len


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_inf_at_the_padding_column_spares_rows_that_do_not_read_it(cuda,
                                                                    pair):
    """x = inf at column 0 (perm[0] after the column permutation, where
    every padding slot points): the kernel reads padding only below a
    group's length, so a row is non-finite exactly where it reads that
    column or its group is longer than it; the plain version, as the JAX
    kernels, multiplies every padding slot by x[0]. Groups of equal rows
    (Laplace3D's interior) therefore stay finite."""
    for stream, scs in padded_streams(1024, 1).items():
        dev = pair_dev(scs, pair, cuda)
        pad_col, uses, counts, group_len = uses_and_group_lengths(scs)
        x, _ = randn_pair((scs.n_rows_padded,), pair[1], cuda, 3)
        x[pad_col] = float("inf")
        y = spmv_scs(dev, x).cpu().numpy()
        bad = ~np.isfinite(y)
        want = uses | (counts < group_len)
        assert np.array_equal(bad, want), stream
        chunk_len = np.repeat(scs.chunk_lengths.astype(np.int64), scs.C)
        plain_bad = ~np.isfinite(spmv_scs_plain(dev, x).cpu().numpy())
        assert np.array_equal(plain_bad, uses | (counts < chunk_len)), stream
        # rows the group lengths spare: finite here, NaN in the plain version
        assert (plain_bad & ~bad).any(), stream


# ------------------------------------------------- row-sharded execution


def sharded(mtx, device, devices=None, **kw):
    """The sharded operator of ``mtx`` with its shards on ``devices``
    (default: every shard on ``device``, card 0 on the card, whatever the
    host holds); ``spread`` takes the default placement over the cards."""
    if devices is None:
        devices = [torch.device("cuda", 0) if device.type == "cuda"
                   else device]
    return spread(mtx, device, devices=devices, **kw)


def spread(mtx, device, devices=None, **kw):
    """The sharded operator as ``from_mtx`` places it: its shards over
    min(R, visible cards) cards on the card."""
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    cfg = dict(kernel_format="scs", chunk_size=32, sigma=1, value_type="sp",
               n_shards=4, backend="cpu" if device.type == "cpu" else "cuda")
    cfg.update(kw)
    return DistributedSpmvOperator.from_mtx(Config(**cfg), mtx,
                                            devices=devices)


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 4),
                                       ("colwise", 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_exchange_bit_equal_to_plain(cuda, dtype, layout, bs):
    from uspmv_tpu_torch.ops import halo_exchange as hx

    op = sharded(laplace2d(64), cuda, block_vec_size=bs, vector_layout=layout,
                 seg_method="seg-nnz")
    ex = op.groups[0].exchanges["sp"]
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


@pytest.mark.parametrize("layout,bs", [("rowwise", 1), ("rowwise", 4),
                                       ("colwise", 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_halo_pack_and_unpack_bit_equal_to_plain(cuda, dtype, layout, bs):
    """Process 0's side of a run of 2 processes of 2 shards each: its rows
    to send, packed, and its rows to receive, unpacked, each one launch
    bit-equal to the plain version (index_select / index_copy_)."""
    from uspmv_tpu_torch.ops import halo_exchange as hx
    from uspmv_tpu_torch.parallel.halo import split_exchange_rows

    op = sharded(laplace2d(64), cuda, block_vec_size=bs, vector_layout=layout,
                 seg_method="seg-nnz")
    L = op.lengths["sp"]
    _, _, send, recv = split_exchange_rows(op.halo_plans["sp"], L,
                                           np.array([0, 0, 1, 1]), 0)
    tr = hx.build_device_transfer(send, recv, 2, L, True, cuda)
    assert tr.n_send == tr.n_recv == 64
    gen = torch.Generator(device=cuda).manual_seed(bs)
    shape = ((2, L) if bs == 1 else (bs, 2, L) if layout == "colwise"
             else (2, L, bs))
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    buf = torch.zeros(tr.buffer_shape(tr.n_send, bs), dtype=dtype,
                      device=cuda)
    pack, unpack = hx.PACK_ENTRY_POINTS[dtype], hx.UNPACK_ENTRY_POINTS[dtype]
    before = hx.launch_counts()
    hx.halo_pack(tr, x, buf, layout)
    inc = torch.randn(tr.buffer_shape(tr.n_recv, bs), generator=gen,
                      device=cuda).to(dtype)
    got = hx.halo_unpack(tr, inc, x.clone(), layout)
    torch.cuda.synchronize()
    after = hx.launch_counts()
    assert after[pack] == before[pack] + 1
    assert after[unpack] == before[unpack] + 1
    assert torch.equal(buf, hx.halo_pack_plain(tr, x, torch.empty_like(buf),
                                               layout))
    assert torch.equal(got, hx.halo_unpack_plain(tr, inc, x.clone(), layout))
    assert not torch.equal(got, x)


HALO_LAYOUTS = [("rowwise", 1), ("rowwise", 3), ("rowwise", 4),
                ("rowwise", 8), ("colwise", 4)]
HALO_KINDS = ["exchange", "pack", "unpack"]


def halo_case(kind, n, layout, bs, dtype, offset, device):
    """(plan, x, the buffer or None, the target's start, the plain result)
    of one halo kernel: a stacked x of 2 shards of L rows, n distinct
    sources among the local rows (the first half of each shard) and n
    distinct destinations among the halo rows; index arrays that start
    ``offset`` words into their allocation, copied to the card as the
    plan's build functions copy them. The target is the buffer of the
    pack and x of the exchange and the unpack."""
    from uspmv_tpu_torch.ops import halo_exchange as hx

    L = 2 * n + 8
    rng = np.random.default_rng(n + offset)
    local = np.concatenate([np.arange(L // 2) + r * L for r in range(2)])
    halo = local + L // 2
    src = rng.choice(local, n, replace=False)
    dst = rng.choice(halo, n, replace=False)

    def rows(a):
        words = np.concatenate([np.zeros(offset, np.int32),
                                a.astype(np.int32)])
        return torch.from_numpy(words).to(device)[offset:]

    def values(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(
            device)

    x = values((2, L) if bs == 1 else (2, L, bs) if layout == "rowwise"
               else (bs, 2, L))
    if kind == "exchange":
        plan = hx.DeviceExchange(src=rows(src), dst=rows(dst), n_shards=2,
                                 length=L)
        return plan, x, None, x, hx.halo_exchange_plain(plan, x.clone(),
                                                        layout)
    plan = hx.DeviceTransfer(send=rows(src), recv=rows(dst), send_counts=[n],
                             recv_counts=[n], n_shards=2, length=L,
                             active=True)
    buf = values(plan.buffer_shape(n, bs))
    if kind == "pack":
        start = torch.zeros_like(buf)
        return plan, x, buf, start, hx.halo_pack_plain(plan, x, start.clone(),
                                                       layout)
    return plan, x, buf, x, hx.halo_unpack_plain(plan, buf, x.clone(), layout)


def halo_call(kind, plan, x, buf, target, layout):
    """One call of the kind's wrapper, writing ``target``."""
    from uspmv_tpu_torch.ops import halo_exchange as hx

    if kind == "exchange":
        hx.halo_exchange(plan, target, layout)
    elif kind == "pack":
        hx.halo_pack(plan, x, target, layout)
    else:
        hx.halo_unpack(plan, buf, target, layout)


def halo_entry(kind, dtype):
    from uspmv_tpu_torch.ops import halo_exchange as hx

    return {"exchange": hx._ENTRY_POINTS, "pack": hx.PACK_ENTRY_POINTS,
            "unpack": hx.UNPACK_ENTRY_POINTS}[kind][dtype]


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("n", [1, 2, 5, 4 * 1000 + 3])
@pytest.mark.parametrize("layout,bs", HALO_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", HALO_KINDS)
def test_halo_kernels_bit_equal_eagerly_and_in_a_graph(cuda, kind, dtype,
                                                       layout, bs, n, offset):
    """Each call launches once (in a capture too: one node) and gives the
    plain version's bits, at ragged lengths, in every layout, with index
    arrays at any word offset; the card's geometry is launch_geometry's."""
    from uspmv_tpu_torch.ops import halo_exchange as hx

    plan, x, buf, start, want = halo_case(kind, n, layout, bs, dtype, offset,
                                          cuda)
    name = halo_entry(kind, dtype)
    before = hx.launch_counts()[name]
    got = start.clone()
    halo_call(kind, plan, x, buf, got, layout)
    torch.cuda.synchronize()
    assert hx.launch_counts()[name] == before + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, start)
    target = start.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        halo_call(kind, plan, x, buf, target, layout)
    assert hx.launch_counts()[name] == before + 2
    for _ in range(2):
        target.copy_(start)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(target, want)
    geo = hx.device_geometry(kind, plan, x, buf, layout)
    n_vec, ld, ncols, vstride = ((bs, 1, 1, 2 * plan.length)
                                 if layout == "colwise" else (1, bs, bs, 0))
    assert geo == hx.launch_geometry(
        n, n_vec, ld, ncols, x.element_size(), geo["n_sm"],
        geo["blocks_per_sm"], vstride)
    assert geo["n_sm"] == torch.cuda.get_device_properties(
        cuda).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", HALO_KINDS)
def test_halo_kernels_loop_beyond_one_wave(cuda, kind, dtype):
    """More pairs than one wave of threads holds: the grid-stride loop
    takes every thread several turns."""
    from uspmv_tpu_torch.ops import halo_exchange as hx

    n = 4 * 2**20 + 3
    plan, x, buf, start, want = halo_case(kind, n, "rowwise", 1, dtype, 0,
                                          cuda)
    geo = hx.device_geometry(kind, plan, x, buf)
    assert geo["grid"] * geo["threads"] * 4 < n
    got = start.clone()
    halo_call(kind, plan, x, buf, got, "rowwise")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def cli_processes(tmp_path, args, n=2, visible=None):
    """The CLI line ``args`` on n processes of this host (``visible``: the
    CUDA_VISIBLE_DEVICES of the run); their outputs, after asserting that
    every process exited 0."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    procs = [subprocess.Popen(
        [sys.executable, "-m", "uspmv_tpu_torch.cli", *args, "-mtx_out",
         str(tmp_path), "-coordinator", f"127.0.0.1:{port}",
         "-n_processes", str(n), "-process_id", str(pid)],
        cwd=repo, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(n)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, outs
    return outs


def test_two_processes_share_the_card_over_gloo(cuda, tmp_path):
    """Two processes of the CLI on one card: NCCL refuses two ranks on one
    device, so the transport is gloo through pinned host buffers; the
    solve validates on process 0."""
    outs = cli_processes(tmp_path, [
        "Laplace2D,64", "scs", "-c", "32", "-sp", "-n_shards", "4", "-mode",
        "s", "-rev", "3", "-validate", "1", "-verbose", "1",
        "-local_devices", "2"], visible="0")
    assert "'transport': 'gloo-staged'" in outs[0], outs[0]
    assert "impl: solve-loop[cuda-dist4-" in outs[0] and "[OK]" in outs[0]
    assert "[OK]" not in outs[1]


@pytest.mark.parametrize("R", [4, 8])
def test_two_processes_of_two_cards(cuda, tmp_path, R):
    """Four cards (hosts with fewer skip): two processes of the CLI take
    two cards each, their R / 2 shards spread over them, the rows between
    processes staged through each one's first card for NCCL; the solve
    runs as one CUDA graph a process and validates on process 0."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import ast
    import json

    outs = cli_processes(tmp_path, [
        "Laplace2D,64", "scs", "-c", "32", "-sp", "-n_shards", str(R),
        "-mode", "s", "-rev", "5", "-validate", "1", "-verbose", "1",
        "-local_devices", str(R // 2)])
    lines = outs[0].splitlines()
    mh = ast.literal_eval([ln for ln in lines
                           if ln.startswith("[multihost]")][0][12:])
    assert mh["transport"] == "nccl"
    assert mh["process_devices"] == [["cuda:0", "cuda:1"],
                                     ["cuda:2", "cuda:3"]]
    cards = json.loads([ln for ln in lines if ln.startswith("[cards]")][0][8:])
    assert cards["cards"] == ["cuda:0", "cuda:1"]
    assert cards["transport"] == "nccl+peer"
    assert f"impl: solve-graph[cuda-dist{R}-4cards-scs-sp]" in outs[0]
    assert "[OK]" in outs[0] and "[OK]" not in outs[1]


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
    n_ex = sum(1 for e in op.groups[0].exchanges.values() if e is not None and e.n)
    assert sum(hx.launch_counts().values()) - n0 == n_ex


def test_sharded_backend_cuda_without_a_gpu_raises(cuda, monkeypatch):
    from uspmv_tpu_torch.runtime.operator import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        spread(laplace2d(16), cuda)


# ------------------------------------------- card groups in one process

CARD_CASES = ["sp-overlap", "sp-no-overlap", "sp-allgather", "sp-rowwise-4",
              "sp-colwise-4", "ap[dp_sp]", "sp-pieces-packed"]


def card_case(case):
    """(matrix, operator keywords) of a sharded case, its rows scaled so
    that the row sums of |A| are <= 1 (solves stay finite)."""
    kw = dict(SHARDED_CASES[case])
    mtx = imbalanced() if kw.pop("matrix", None) else laplace2d(64)
    mtx.values[:] = mtx.values / np.bincount(
        mtx.I, weights=np.abs(mtx.values)).max()
    return mtx, kw


def check_groups_against_one(one, op, x_host):
    """op (several groups) against one (one group) of the same config:
    eager y, a replayed bench batch and a graph solve bit for bit; the
    pack and unpack launched where rows cross groups, and the graph's
    nodes hold them."""
    from uspmv_tpu_torch.ops import halo_exchange as hx

    want = one.to_host(one.spmv(one.make_x(x_host)))
    x = op.make_x(x_host)
    before = hx.launch_counts()
    y = op.spmv(x)
    torch.cuda.synchronize()
    assert np.array_equal(op.to_host(y), want)
    launched = {k: n - before[k] for k, n in hx.launch_counts().items()}
    crossing = any(grp.tbufs for grp in op.groups)
    if crossing:
        for table in (hx.PACK_ENTRY_POINTS, hx.UNPACK_ENTRY_POINTS):
            assert launched[table[op.working_dtype]] > 0, launched
    g = op.batch_graph(x, 3)
    op.replay(g, 2)
    torch.cuda.synchronize()
    assert np.array_equal(op.to_host(g.bufs[0]), want)
    if crossing:
        assert g.nodes[hx.PACK_ENTRY_POINTS[op.working_dtype]] > 0, g.nodes
    assert op.solve_impl_name(5) == "graph"
    loop = op.solve(op.make_x(x_host), 5, impl="loop")
    graph = op.solve(op.make_x(x_host), 5)
    ref = one.solve(one.make_x(x_host), 5)
    torch.cuda.synchronize()
    for a, b, c in zip(loop, graph, ref):
        assert np.array_equal(op.to_host(a), op.to_host(b))
        assert np.array_equal(op.to_host(b), one.to_host(c))


@pytest.mark.parametrize("case", CARD_CASES)
def test_two_groups_on_one_card_equal_one_group(cuda, case):
    """The rehearsal of pack -> copy -> unpack: R=4 as two groups on the
    first card, eagerly and in captured graphs, bit-equal to one group."""
    mtx, kw = card_case(case)
    d0 = torch.device("cuda", 0)
    one = sharded(mtx, cuda, devices=[d0], **kw)
    two = sharded(mtx, cuda, devices=[d0, d0], **kw)
    assert two.n_cards == 2 and two.transport() == "peer"
    assert two.impl_name() == one.impl_name().replace("dist4-",
                                                      "dist4-2cards-")
    bs = kw.get("block_vec_size", 1)
    x_host = np.random.default_rng(6).standard_normal(
        (mtx.n_rows, bs) if bs > 1 else mtx.n_rows)
    check_groups_against_one(one, two, x_host)


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("case", ["sp-overlap", "sp-no-overlap",
                                  "sp-allgather", "ap[dp_sp]",
                                  "sp-colwise-4"])
def test_four_cards_equal_one_card(cuda, case, R):
    """The default placement over four cards (hosts with fewer skip): R
    shards on min(R, 4) cards, peer copies between them, bit-equal to the
    same operator on one card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    mtx, kw = card_case(case)
    op = spread(mtx, cuda, n_shards=R, **kw)
    one = sharded(mtx, cuda, n_shards=R, **kw)
    assert op.n_cards == 4 and op.transport() == "peer"
    assert [g.device.index for g in op.groups] == [0, 1, 2, 3]
    bs = kw.get("block_vec_size", 1)
    x_host = np.random.default_rng(6).standard_normal(
        (mtx.n_rows, bs) if bs > 1 else mtx.n_rows)
    check_groups_against_one(one, op, x_host)


def test_four_cards_full_size_replays_read_their_own_x(cuda):
    """The headline's matrix (Laplace3D-128, C=1024, sigma=1, sp) at R=4
    over four cards, hosts with fewer skip: a graph solve of 5 and a
    replayed bench batch, each from a new x, many times, bit-equal to one
    card's every time and read back with no synchronize in between (the
    replay waits for the copies into its input on every card, and what
    reads its output waits for the replay)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    from uspmv_tpu_torch.io import generators

    mtx = generators.laplace3d(128)
    mtx.values[:] = mtx.values / 16.0  # row sums of |A| <= 12/16
    kw = dict(chunk_size=1024, n_shards=4)
    op, one = spread(mtx, cuda, **kw), sharded(mtx, cuda, **kw)
    assert op.n_cards == 4 and op.solve_impl_name(5) == "graph"
    rng = np.random.default_rng(18)
    for _ in range(12):
        x_host = rng.standard_normal(mtx.n_rows)
        got = op.solve(op.make_x(x_host), 5)
        ref = one.solve(one.make_x(x_host), 5)
        for a, b in zip(got, ref):
            assert np.array_equal(op.to_host(a), one.to_host(b))
        g = op.batch_graph(op.make_x(x_host), 3)
        op.replay(g, 2)
        y = one.spmv(one.make_x(x_host))
        assert np.array_equal(op.to_host(g.bufs[0]), one.to_host(y))


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


def test_spmv_span_books_its_launches_on_the_card(cuda):
    """With spans on, each ``spmv`` span holds the launches made inside it
    (one SELL launch here, its heavy-row pieces' too with a split), the
    process's launch total moves with the wrappers' counts, and the build
    books the bytes of the device streams."""
    from uspmv_tpu_torch.ops import scs_pieces
    from uspmv_tpu_torch.runtime import profiling

    mtx = random_banded(20_000, 400, 12)
    for kw, per_call in ((dict(split_rows_threshold=-1), 1),
                         (dict(split_rows_threshold=4), 2)):
        profiling.reset()
        profiling.enable()
        try:
            op = SpmvOperator.from_mtx(
                Config(kernel_format="scs", chunk_size=32, sigma=1,
                       value_type="dp", backend="cuda", mixed_tiles=False,
                       **kw), mtx)
            x = op.make_x()
            y = torch.zeros_like(x)
            n0 = launch_count() + scs_pieces.launch_count()
            for _ in range(10):
                op.spmv(x, out=y)
            torch.cuda.synchronize()
            n = launch_count() + scs_pieces.launch_count() - n0
        finally:
            profiling.disable()
        snap = profiling.snapshot()
        assert n == 10 * per_call
        assert snap["spans"]["spmv"] == dict(
            snap["spans"]["spmv"], count=10, launches=n)
        assert snap["counters"]["launches"] == n
        assert snap["counters"]["upload_bytes"] == sum(
            op.device_bytes().values())
        assert snap["spans"]["from_scs.upload"]["parent"] == "from_mtx"
    profiling.reset()


@pytest.mark.parametrize("bs,layout", [(1, "colwise"), (8, "colwise"),
                                       (16, "colwise"), (16, "rowwise")])
@pytest.mark.parametrize("tier", ["sell", "packed", "sell+pieces"])
def test_matrix_passes_booked_per_launch_on_the_card(cuda, tier, bs,
                                                     layout):
    """Each SpMV books beside its launches the passes its kernels make
    over their matrix streams: a SELL-C-sigma or pieces stream one per
    pass of up to 8 vectors, a packed stream one (``matrix_passes``)."""
    from uspmv_tpu_torch.runtime import profiling

    kw = {"sell": dict(mixed_tiles=False, split_rows_threshold=-1),
          "packed": dict(mixed_tiles=True, split_rows_threshold=-1),
          "sell+pieces": dict(mixed_tiles=False, split_rows_threshold=4)}
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=1, value_type="sp",
               backend="cuda", block_vec_size=bs, vector_layout=layout,
               **kw[tier]), random_banded(20_000, 400, 12))
    assert bool(op.pieces) == (tier == "sell+pieces")
    per_call = op.matrix_passes(tier == "packed") + (
        vector_pass_count(bs) if op.pieces else 0)
    x = op.make_x()
    y = torch.zeros_like(x)
    op.spmv(x, out=y)
    torch.cuda.synchronize()
    profiling.reset()
    for _ in range(5):
        op.spmv(x, out=y)
    torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters[profiling.MATRIX_PASSES] == 5 * per_call
    assert per_call == {"sell": vector_pass_count(bs), "packed": 1,
                        "sell+pieces": 2 * vector_pass_count(bs)}[tier]


@pytest.mark.parametrize("impl,sigma", [("auto", 1), ("auto", 8),
                                         ("xla", 1)])
def test_row_index_is_built_only_where_read_on_the_card(cuda, impl, sigma):
    """The kernels read no row index: after the build and SpMVs on the
    kernel route none is on the card and ``row_index_builds`` reads 0; the
    plain route (impl='xla') builds it once at its first SpMV; read, it is
    the host's ``flat_row_idx()`` element for element, on the card."""
    from uspmv_tpu_torch.runtime import profiling

    profiling.reset()
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=sigma,
               value_type="dp", backend="cuda", impl=impl,
               split_rows_threshold=-1, mixed_tiles=False),
        random_banded(20_000, 400, 12))
    x = op.make_x()
    y = torch.zeros_like(x)
    for _ in range(3):
        op.spmv(x, out=y)
    torch.cuda.synchronize()
    builds = profiling.snapshot()["counters"].get("row_index_builds", 0)
    assert builds == (1 if impl == "xla" else 0)
    assert ("dp.row_idxs" in op.device_bytes()) == (impl == "xla")
    rows = op.devs["dp"].row_idxs
    assert rows.device.type == "cuda" and rows.dtype == torch.int32
    assert np.array_equal(rows.cpu().numpy(), op.scs["dp"].flat_row_idx())
    profiling.reset()


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


# ------------------------------------- slice 13: the bench's CUDA graphs

BATCH_CASES = {
    "sp": dict(value_type="sp"),
    "dp": dict(value_type="dp"),
    "hp": dict(value_type="hp"),
    "ap[dp_sp]-dp_emu": dict(value_type="ap[dp_sp]", dp_emulation=True,
                             ap_threshold_1=0.5),
    "sp-rowwise-8": dict(value_type="sp", block_vec_size=8,
                         vector_layout="rowwise"),
    "sp-colwise-4": dict(value_type="sp", block_vec_size=4,
                         vector_layout="colwise"),
    "packed": dict(value_type="sp", mixed_tiles=True,
                   split_rows_threshold=-1),
    "scs+pieces": dict(value_type="sp", mixed_tiles=False,
                       split_rows_threshold=8),
    "xla": dict(value_type="sp", impl="xla"),
    "sharded-overlap": dict(value_type="sp", n_shards=4),
    "sharded-no-overlap": dict(value_type="sp", n_shards=4,
                               overlap_comm=False),
    "bcoo": dict(value_type="sp", impl="bcoo"),
}


def batch_operator(case):
    """The operator of BATCH_CASES[case] on the card, over an imbalanced
    matrix (so the split and packed cases have pieces and row groups)."""
    from uspmv_tpu_torch.ops.spmv_bcoo import BcooSpmvOperator
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    kw = dict(BATCH_CASES[case])
    cfg = Config(kernel_format="scs", chunk_size=32, sigma=64,
                 backend="cuda", **kw)
    mtx = imbalanced()
    if kw.get("impl") == "bcoo":
        return BcooSpmvOperator.from_mtx(cfg, mtx)
    if kw.get("n_shards"):  # every shard on card 0
        return DistributedSpmvOperator.from_mtx(
            cfg, mtx, devices=[torch.device("cuda", 0)])
    return SpmvOperator.from_mtx(cfg, mtx)


def all_launches():
    from uspmv_tpu_torch.ops import halo_exchange, scs_packed, scs_pieces

    return sum(sum(m.launch_counts().values()) for m in
               (scs_spmv, scs_packed, scs_pieces, halo_exchange))


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_bench_batch_graph_equals_eager_spmv(cuda, case):
    """y of a replayed bench batch against eager ``op.spmv``: bit for bit
    through this package's kernels, within the sp tolerance where the sums'
    order may vary from call to call (the plain route's index_add_ and
    cuSPARSE's CSR product); the replay counts G kernel nodes per SpMV node
    and launches nothing through the wrappers."""
    op = batch_operator(case)
    bs = op.config.block_vec_size
    x = op.make_x(np.random.default_rng(8).standard_normal(
        (op.n_rows, bs) if bs > 1 else op.n_rows))
    want = op.spmv(x.clone())
    G = 10
    g = op.batch_graph(x, G)
    per_spmv = sum(g.nodes.values()) // G
    assert sum(g.nodes.values()) == G * per_spmv
    assert per_spmv > 0 or not uses_kernels(op)
    for _ in range(2):
        n0, g0 = all_launches(), sum(graph_nodes_replayed().values())
        op.replay(g, 3)
        torch.cuda.synchronize()
        assert all_launches() == n0
        assert sum(graph_nodes_replayed().values()) - g0 == 3 * G * per_spmv
        got = g.bufs[0]
        if case in ("xla", "bcoo"):
            assert (got - want).abs().max().item() <= \
                TOL["sp"] * want.abs().max().item()
        else:
            assert np.array_equal(op.to_host(got), op.to_host(want))
    assert op.batch_graph(x, G) is g  # kept, not captured again


def uses_kernels(op):
    from uspmv_tpu_torch.runtime.operator import uses_kernels as uk

    return uk(op.config)


@pytest.mark.parametrize("case", ["sp", "scs+pieces", "sharded-overlap",
                                  "bcoo"])
def test_bench_spmv_times_replays(cuda, case):
    """bench_spmv on the card: timing "graph", n = start_iters * 2^j, at
    least n kernel nodes per SpMV node replayed in the timed batches, and
    the wrappers' only launches those of the capture's warm-up SpMV."""
    from uspmv_tpu_torch.runtime.bench import bench_spmv

    op = batch_operator(case)
    x = op.make_x()
    n0 = all_launches()
    op.spmv(x.clone())
    torch.cuda.synchronize()
    per_spmv_launches = all_launches() - n0
    n0, g0 = all_launches(), sum(graph_nodes_replayed().values())
    res = bench_spmv(op, x=x, bench_time=0.01, warmup=5, start_iters=4,
                     timing_reps=2)
    torch.cuda.synchronize()
    assert res.timing == "graph" and res.to_dict()["timing"] == "graph"
    ratio = res.n_iterations // 4
    assert res.n_iterations == 4 * ratio and ratio & (ratio - 1) == 0
    assert all_launches() - n0 == per_spmv_launches
    nodes = sum(graph_nodes_replayed().values()) - g0
    assert nodes >= 2 * res.n_iterations * per_spmv_launches
    assert res.perf_gflops > 0


@pytest.mark.parametrize("k", [1, 2, 7])
def test_bench_solve_graph_equals_solve(cuda, k):
    """bench_solve by graph replays the captured solve from x copied in
    once: its buffers hold op.solve(x, k, "graph")'s bits."""
    from uspmv_tpu_torch.runtime.bench import bench_solve

    mtx = laplace2d(33)
    mtx.values[:] = mtx.values * 0.1
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=32, sigma=8, value_type="sp",
               backend="cuda"), mtx)
    x = op.make_x(np.random.default_rng(k).standard_normal(mtx.n_rows))
    want_prev, want = op.solve(x, k, impl="graph")
    loop_prev, loop = op.solve(x, k, impl="loop")
    assert torch.equal(want, loop) and torch.equal(want_prev, loop_prev)
    n0 = launch_count()
    res = bench_solve(op, k, x=x, bench_time=0.01, warmup=1, impl="graph")
    torch.cuda.synchronize()
    assert res.timing == "graph" and res.impl == "solve-graph[cuda-scs-sp]"
    assert launch_count() == n0  # the graph was cached: no capture
    g = op.solve_graph(x, k)
    assert torch.equal(g.bufs[(k - 1) & 1], want)
    if k > 1:
        assert torch.equal(g.bufs[k & 1], want_prev)


def test_capture_failure_names_the_operator(cuda, monkeypatch):
    """A host sync inside the SpMV makes the capture fail: it raises with
    the operator's impl_name and does not fall back to a loop."""
    op = batch_operator("sp")
    x = op.make_x()
    spmv = op.spmv

    def syncing(xx, out=None):
        y = spmv(xx, out=out)
        float(y.sum())  # a host read: illegal while capturing
        return y

    monkeypatch.setattr(op, "spmv", syncing)
    with pytest.raises(RuntimeError, match="capture of cuda-"):
        op.batch_graph(x, 3)


def load_cg_example():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", "cg_solver_torch.py")
    spec = importlib.util.spec_from_file_location("cg_solver_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("maxiter", [25, 60])
def test_graph_cg_equals_eager_cg(cuda, maxiter):
    """The CG example's graph batches (one per batch size: 25, and 10 at
    maxiter 60) against its eager steps: the same iterations, the same
    bits of x."""
    import uspmv_tpu_torch.interface as tui

    ex = load_cg_example()
    mtx = laplace2d(40)
    h = tui.prepare(mtx, C=1024, sigma=1, value_type="sp", backend="cuda")
    b = mtx.to_scipy().tocsr() @ np.random.default_rng(2).standard_normal(
        mtx.n_rows)
    x_e, it_e, res_e = ex.cg(h, b, tol=1e-30, maxiter=maxiter,
                             batches=ex.eager_batches)
    x_g, it_g, res_g = ex.cg(h, b, tol=1e-30, maxiter=maxiter)
    assert it_g == it_e == maxiter and res_g == res_e
    assert np.array_equal(x_g, x_e)
