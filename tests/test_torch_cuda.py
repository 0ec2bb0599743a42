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
from uspmv_tpu_torch.runtime.operator import SpmvOperator

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
