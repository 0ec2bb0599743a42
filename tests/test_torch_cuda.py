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
    op = SpmvOperator.from_mtx(
        Config(kernel_format="scs", chunk_size=C, sigma=sigma,
               value_type=value_type, backend="cuda"), mtx)
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
