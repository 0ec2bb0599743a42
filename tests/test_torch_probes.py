"""The last TPU kernels' counterparts in uspmv_tpu_torch against the JAX
package: the unit-value SELL stream, the cost variants of the SELL row loop
and the x-gather probes.

On the CPU every wrapper runs its plain PyTorch version. The unit stream is
held against the JAX lane-tile kernel with ``unit=True`` (Pallas interpret
mode) on the very same SCS arrays, the ``full`` cost variant against the
plain lane-tile kernel, the other variants against numpy formulas on the
SCS arrays (they have no JAX counterpart that runs on the CPU), and the
gather modes against the JAX package's CPU gathers (``gather_sublanes``,
``gather_lanes``, ``gather_window``) and the probe scripts' own numpy
formulas. The CUDA kernels are checked on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.formats.scs import permute_scs_cols as j_permute
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.ops.gather_primitive import (
    gather_lanes,
    gather_sublanes,
    gather_window,
)
from uspmv_tpu.ops.pallas_scs import build_device_lane_tiles, spmv_lane_tiles

from uspmv_tpu_torch.formats.scs import scs_from_reference
from uspmv_tpu_torch.ops import scs_probe, x_access
from uspmv_tpu_torch.ops.device_format import build_device_scs
from uspmv_tpu_torch.ops.scs_solve import solve_fits, solve_scs
from uspmv_tpu_torch.ops.scs_spmv import spmv_scs, spmv_scs_plain
from uspmv_tpu_torch.scripts import gather_probe

CPU = torch.device("cpu")
# f32 sums in another order than the TPU kernel's
TOL = 1e-5


def ones(mtx):
    """The all-ones matrix of ``mtx``'s pattern."""
    return dataclasses.replace(mtx, values=np.ones_like(mtx.values))


UNIT_MATRICES = {
    "laplace3d(8)": lambda: ones(jgen.laplace3d(8)),
    "random_banded(2500,60,11)": lambda: ones(
        jgen.random_banded(2500, 60, 11, seed=8)),
}


def jax_scs(mtx, C, sigma, dtype=np.float32):
    """The JAX package's SCS with the symmetric column permutation, as its
    operator builds it."""
    scs = j_convert(mtx.astype(dtype), C, sigma, native=False)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    j_permute(scs, perm)
    return scs


def permuted_x(scs, seed, bs=1):
    """x scattered to old_to_new of a padded vector, as
    tests/test_pallas.py builds it; the padded slots are 0."""
    shape = (scs.n_rows,) if bs == 1 else (scs.n_rows, bs)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xp = np.zeros((scs.n_rows_padded,) + shape[1:], np.float32)
    xp[scs.old_to_new_idx] = x
    return xp


def port_dev(jscs, **kw):
    return build_device_scs(scs_from_reference(dataclasses.asdict(jscs)),
                            CPU, **kw)


def rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ unit stream


@pytest.mark.parametrize("sigma", [1, 1024])
@pytest.mark.parametrize("name", sorted(UNIT_MATRICES))
def test_unit_plain_matches_jax_unit_kernel(name, sigma):
    jscs = jax_scs(UNIT_MATRICES[name](), 1024, sigma)
    jdev = build_device_lane_tiles(jscs, unit_values=True)
    assert jdev.unit_vals
    xp = permuted_x(jscs, 0)
    y_jax = np.asarray(spmv_lane_tiles(jdev, jnp.asarray(xp), interpret=True))
    dev = port_dev(jscs, unit_values=True)
    assert dev.unit_vals and dev.values.numel() == 0
    y = spmv_scs(dev, torch.from_numpy(xp))
    assert y.dtype == torch.float32 and y.shape == (jscs.n_rows_padded,)
    rows = jscs.old_to_new_idx
    assert rel_err(y.numpy()[rows], y_jax[rows]) < TOL
    # and against the same pattern with explicit ones
    y_ones = spmv_scs(port_dev(jscs), torch.from_numpy(xp))
    assert rel_err(y.numpy(), y_ones.numpy()) < TOL


@pytest.mark.parametrize("layout", ["rowwise", "colwise"])
def test_unit_plain_block_vectors_match_jax_unit_kernel(layout):
    jscs = jax_scs(UNIT_MATRICES["laplace3d(8)"](), 1024, 1)
    xs = permuted_x(jscs, 3, bs=4)
    y_jax = np.asarray(spmv_lane_tiles(
        build_device_lane_tiles(jscs, unit_values=True, block_vec_size=4),
        jnp.asarray(xs), interpret=True))
    dev = port_dev(jscs, unit_values=True)
    x = torch.from_numpy(xs if layout == "rowwise" else xs.T.copy())
    y = spmv_scs(dev, x, layout).numpy()
    if layout == "colwise":
        y = y.T
    rows = jscs.old_to_new_idx
    assert rel_err(y[rows], y_jax[rows]) < TOL


def test_unit_accumulate_form_adds_into_y():
    jscs = jax_scs(UNIT_MATRICES["laplace3d(8)"](), 32, 4)
    dev = port_dev(jscs, unit_values=True)
    x = torch.from_numpy(permuted_x(jscs, 4))
    y0 = torch.randn(dev.n_rows_padded, generator=torch.Generator()
                     .manual_seed(1))
    got = spmv_scs(dev, x, y=y0.clone())
    want = y0 + spmv_scs_plain(dev, x)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)


def test_unit_stream_layout():
    """Padding slots get column -1, the values go, 4 B per element are
    streamed (the unit loop walks each chunk to its length, every slot),
    and x_len ignores the padding."""
    jscs = jax_scs(UNIT_MATRICES["random_banded(2500,60,11)"](), 128, 32)
    dev = port_dev(jscs, unit_values=True)
    full = port_dev(jscs)
    pad = jscs.values == 0
    assert pad.any()
    cols = dev.col_idxs.numpy()
    assert np.all(cols[pad] == -1)
    assert np.array_equal(cols[~pad], jscs.col_idxs[~pad])
    assert dev.stream_bytes() == dev.chunk_stream_bytes() == (
        full.chunk_stream_bytes() - 4 * jscs.n_elements)
    assert dev.n_read == jscs.n_elements
    assert dev.x_len == int(jscs.col_idxs[~pad].max()) + 1
    assert torch.equal(dev.row_idxs, full.row_idxs)


def test_unit_refusals_match_jax():
    mtx = jgen.laplace3d(4)  # values 6 and -1: not an all-ones matrix
    jscs = jax_scs(mtx, 1024, 1)
    with pytest.raises(ValueError) as j_err:
        build_device_lane_tiles(jscs, unit_values=True)
    with pytest.raises(ValueError) as t_err:
        port_dev(jscs, unit_values=True)
    assert str(t_err.value) == str(j_err.value) == \
        "unit_values requires an all-ones matrix"
    ones_scs = jax_scs(ones(mtx), 1024, 1)
    for j_dtype, t_dtype in ((np.float64, torch.float64),
                             ("bfloat16", torch.bfloat16)):
        if j_dtype == "bfloat16":
            import ml_dtypes

            j_dtype = ml_dtypes.bfloat16
        with pytest.raises(ValueError) as j_err:
            build_device_lane_tiles(ones_scs, dtype=j_dtype, unit_values=True)
        with pytest.raises(ValueError) as t_err:
            port_dev(ones_scs, dtype=t_dtype, unit_values=True)
        assert str(t_err.value) == str(j_err.value) == \
            "unit_values requires plain f32 tiles"


def test_unit_stream_refuses_other_x_and_the_fused_solve():
    jscs = jax_scs(UNIT_MATRICES["laplace3d(8)"](), 1024, 1)
    dev = port_dev(jscs, unit_values=True)
    n = dev.n_rows_padded
    with pytest.raises(TypeError, match="float32 x"):
        spmv_scs(dev, torch.zeros(n, dtype=torch.float64))
    assert not solve_fits(dev, (n,), torch.float32)
    with pytest.raises(ValueError, match="unit-value"):
        solve_scs(dev, torch.zeros(n), 2)


# ---------------------------------------------------------- cost variants


COST_MATRICES = {
    "laplace3d(8)": lambda: jgen.laplace3d(8),
    "random_banded(2500,60,11)": lambda: jgen.random_banded(2500, 60, 11,
                                                            seed=8),
}


@pytest.mark.parametrize("name", sorted(COST_MATRICES))
def test_full_variant_matches_lane_tile_kernel(name):
    jscs = jax_scs(COST_MATRICES[name](), 1024, 1)
    xp = permuted_x(jscs, 5)
    y_jax = np.asarray(spmv_lane_tiles(build_device_lane_tiles(jscs),
                                       jnp.asarray(xp), interpret=True))
    y, stored = scs_probe.probe_scs(port_dev(jscs), torch.from_numpy(xp),
                                    "full")
    assert stored.item() == 0
    rows = jscs.old_to_new_idx
    assert rel_err(y.numpy()[rows], y_jax[rows]) < TOL


def numpy_variant(scs, x, variant):
    """Each cost variant in f64 from the SCS arrays."""
    col = scs.col_idxs.astype(np.int64)
    rows = scs.flat_row_idx()
    g = {
        "full": lambda: x[col],
        "no_store": lambda: x[col],
        "x_window": lambda: x[col & (scs_probe.x_window(x.size) - 1)],
        "no_x": lambda: col.astype(np.float64),
        "bare": lambda: col.astype(np.float64),
        "x_row": lambda: x[rows],
    }[variant]()
    y = np.zeros(scs.n_rows_padded)
    np.add.at(y, rows, scs.values.astype(np.float64) * g)
    return y


@pytest.mark.parametrize("variant", scs_probe.VARIANTS)
@pytest.mark.parametrize("C,sigma", [(1024, 1), (32, 8), (1, 1)])
def test_cost_variants_match_numpy(variant, C, sigma):
    """Every row stored (the threshold -inf of no_store and bare); then, at
    +inf, no_store and bare leave y as it was and count nothing."""
    jscs = jax_scs(COST_MATRICES["random_banded(2500,60,11)"](), C, sigma)
    dev = port_dev(jscs)
    x = torch.from_numpy(permuted_x(jscs, 6))
    y0 = torch.full((jscs.n_rows_padded,), 3.0)
    y, stored = scs_probe.probe_scs(dev, x, variant, y=y0.clone())
    thresholded = variant in scs_probe.THRESHOLDED
    assert stored.item() == (jscs.n_rows_padded if thresholded else 0)
    want = numpy_variant(jscs, x.numpy().astype(np.float64), variant)
    assert rel_err(y.numpy(), want) < TOL
    if thresholded:
        y, stored = scs_probe.probe_scs(dev, x, variant, y=y0.clone(),
                                        store_above=float("inf"))
        assert stored.item() == 0 and torch.equal(y, y0)


@pytest.mark.parametrize("variant", ["no_store", "bare"])
def test_no_store_variants_store_and_count_nan_rows(variant):
    """Only rows whose sum exceeds the threshold are written and added to
    the caller's counter; a NaN sum exceeds none, so its row is neither."""
    jscs = jax_scs(COST_MATRICES["laplace3d(8)"](), 32, 1)
    dev = port_dev(jscs)
    bad = np.zeros(jscs.n_elements, bool)
    bad[np.flatnonzero(jscs.values)[[0, 40, 41, 700]]] = True
    values = np.where(bad, np.nan, jscs.values).astype(np.float32)
    dev = dataclasses.replace(dev, values=torch.from_numpy(values))
    x = permuted_x(jscs, 7)
    sums = numpy_variant(dataclasses.replace(jscs, values=values),
                         x.astype(np.float64), variant)
    # halfway across the widest gap between the middle half's finite sums,
    # so that no sum lies near it
    mid = np.sort(sums[np.isfinite(sums)])
    mid = mid[mid.size // 4: 3 * mid.size // 4]
    i = int(np.argmax(np.diff(mid)))
    thr = float(mid[i] + mid[i + 1]) / 2
    y0 = torch.full((dev.n_rows_padded,), -7.0)
    flag = torch.full((1,), 5, dtype=torch.int32)
    y, stored = scs_probe.probe_scs(dev, torch.from_numpy(x), variant,
                                    y=y0, stored=flag, store_above=thr)
    keep = sums > thr  # False where the sum is NaN
    bad_rows = np.unique(jscs.flat_row_idx()[bad])
    assert np.isnan(sums[bad_rows]).all() and 0 < keep.sum() < keep.size
    assert stored is flag and stored.item() == 5 + keep.sum()
    assert not np.isnan(y.numpy()).any()
    assert np.all(y.numpy()[~keep] == -7.0)
    assert rel_err(y.numpy()[keep], sums[keep]) < TOL


def test_x_window_size_and_probe_refusals():
    assert [scs_probe.x_window(n) for n in (1, 5, 4096, 10**6)] == \
        [1, 4, 4096, 4096]
    jscs = jax_scs(COST_MATRICES["laplace3d(8)"](), 1024, 1)
    x = torch.from_numpy(permuted_x(jscs, 8))
    with pytest.raises(ValueError, match="variant"):
        scs_probe.probe_scs(port_dev(jscs), x, "no_values")
    with pytest.raises(TypeError, match="f32 DeviceScs"):
        scs_probe.probe_scs(port_dev(jscs, dtype=torch.float64), x, "full")
    with pytest.raises(TypeError, match="f32 DeviceScs"):
        scs_probe.probe_scs(port_dev(jax_scs(ones(jgen.laplace3d(8)), 1024, 1),
                                     unit_values=True), x, "full")
    with pytest.raises(ValueError, match="too short"):
        scs_probe.probe_scs(port_dev(jscs), x[:10], "x_row")


# ------------------------------------------------------------- x access


def tile_pair(seed):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((8, 128)).astype(np.float32)
    idx = rng.integers(0, 1024, (8, 128)).astype(np.int32)
    return src, idx


def port_gather(src, idx, dim):
    flat = x_access.flat_index(torch.from_numpy(idx), src.shape, dim)
    return x_access.gather_store(torch.from_numpy(src.ravel()),
                                 flat).view(idx.shape).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_store_matches_jax_tile_gathers(seed):
    src, idx = tile_pair(seed)
    np.testing.assert_array_equal(
        port_gather(src, idx, 0),
        np.asarray(gather_sublanes(jnp.asarray(src), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        port_gather(src, idx, 1),
        np.asarray(gather_lanes(jnp.asarray(src), jnp.asarray(idx))))


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_store_composes_the_jax_window_gather(seed):
    """gather_window = lanes of sublanes: the same two flat gathers."""
    w, sub = tile_pair(seed)
    _, lane = tile_pair(seed + 10)
    t1 = port_gather(w, sub, 0)
    got = port_gather(t1, lane, 1)
    want = np.asarray(gather_window(jnp.asarray(w), jnp.asarray(sub),
                                    jnp.asarray(lane)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_shape,idx_shape,dim", gather_probe.SHAPES_1D)
def test_gather_store_matches_gather1d_formula(src_shape, idx_shape, dim):
    """test_gather1d.py:53-63, the script's own expected values."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal(src_shape).astype(np.float32)
    hi = src_shape[dim]
    idx = rng.integers(0, hi, idx_shape).astype(np.int32)
    if src.shape[1 - dim] == idx.shape[1 - dim]:
        want = np.take_along_axis(src, idx % hi, axis=dim)
    elif dim == 0:
        want = src[idx % hi, np.arange(idx_shape[1])[None, :] % src_shape[1]]
    else:
        want = src[np.arange(idx_shape[0])[:, None] % src_shape[0], idx % hi]
    np.testing.assert_array_equal(port_gather(src, idx, dim), want)


@pytest.mark.parametrize("H,W,h,w", gather_probe.SHAPES_2D)
def test_gather_store_matches_gather2d_formula(H, W, h, w):
    """test_gather2d.py:65: out = src.flat[idx mod size]."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal((H, W)).astype(np.float32)
    idx = rng.integers(0, H * W, (h, w)).astype(np.int32)
    want = src.reshape(-1)[idx.reshape(-1) % (H * W)].reshape(h, w)
    np.testing.assert_array_equal(port_gather(src, idx, None), want)


@pytest.mark.parametrize("n", [1, 255, 5000, 300_000])
def test_fma_modes_match_numpy_per_thread_sums(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n + 17).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    idx = rng.integers(0, x.size, n).astype(np.int32)
    T = x_access.fma_threads(n)
    assert T % x_access.BLOCK == 0
    tx, tv, ti = map(torch.from_numpy, (x, v, idx))
    for got, terms in ((x_access.gather_fma(tx, ti, tv), v * x[idx]),
                       (x_access.copy_fma(tx, tv), v * x[:n])):
        want = np.zeros(T)
        np.add.at(want, np.arange(n) % T, terms.astype(np.float64))
        assert got.shape == (T,)
        assert rel_err(got.numpy(), want) <= x_access.fma_tol(n)


def test_fma_threads_and_argument_checks():
    assert x_access.fma_threads(1) == 256
    assert x_access.fma_threads(2**24) == 256 * 1024  # 64 elements each
    assert x_access.fma_threads(2**30) == 256 * x_access.MAX_BLOCKS
    x = torch.zeros(10)
    with pytest.raises(TypeError, match="int32"):
        x_access.gather_store(x, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32"):
        x_access.gather_store(x.double(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be float32 with 256"):
        x_access.gather_fma(x, torch.zeros(3, dtype=torch.int32),
                            torch.zeros(3), out=torch.empty(3))
    with pytest.raises(ValueError, match="reads x"):
        x_access.copy_fma(x, torch.zeros(30))
    out = torch.empty(3)
    assert x_access.gather_store(torch.arange(10.0),
                                 torch.tensor([9, 0, 4], dtype=torch.int32),
                                 out) is out
    assert out.tolist() == [9.0, 0.0, 4.0]


@pytest.mark.parametrize("pattern", gather_probe.PATTERNS)
def test_sweep_patterns(pattern):
    n, n_x = 8192, 4096
    gen = torch.Generator().manual_seed(0)
    idx = gather_probe.sweep_index(pattern, n, n_x, gen, CPU)
    assert idx.dtype == torch.int32 and idx.shape == (n,)
    assert 0 <= idx.min().item() and idx.max().item() < n_x
    e = torch.arange(n)
    if pattern == "banded":
        assert (idx.long() - e * n_x // n).abs().max().item() <= 3
    elif pattern == "strided":
        # all of x once per n_x elements; neighbours 1,024 apart within a
        # column of the [n_x / 1024, 1024] view
        assert torch.equal(torch.sort(idx[:n_x].long())[0], torch.arange(n_x))
        rows = n_x // gather_probe.STRIDE
        step = idx[1:rows].long() - idx[:rows - 1].long()
        assert step.eq(gather_probe.STRIDE).all().item()
