"""The SELL-C-sigma SpMV of uspmv_tpu_torch against the JAX package.

On the CPU ``spmv_scs`` runs its plain PyTorch version; it must agree with
the TPU lane-tile kernels ``spmv_lane_tiles`` (f32, bf16 values with bs
right-hand sides, and the df64 pair kernel; Pallas interpret mode) on the
very same SCS arrays, carried across with ``scs_from_reference``. The CUDA
kernel itself is checked on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.formats.scs import permute_scs_cols as j_permute
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.ops.pallas_scs import build_device_lane_tiles, spmv_lane_tiles

from uspmv_tpu_torch.formats.scs import scs_from_reference
from uspmv_tpu_torch.ops import _build, scs_spmv
from uspmv_tpu_torch.ops.device_format import build_device_scs
from uspmv_tpu_torch.ops.scs_spmv import spmv_scs, spmv_scs_plain

CPU = torch.device("cpu")

MATRICES = {
    "laplace2d(40)": lambda: jgen.laplace2d(40),
    "tridiag(1500)": lambda: jgen.tridiag(1500),
    "random_banded(2500,60,11)": lambda: jgen.random_banded(2500, 60, 11, seed=8),
}


def jax_scs(mtx, C, sigma, dtype):
    """The JAX package's SCS with the symmetric column permutation applied,
    as its operator builds it."""
    scs = j_convert(mtx.astype(dtype), C, sigma, native=False)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    j_permute(scs, perm)
    return scs


def permuted_x(scs, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(scs.n_rows).astype(dtype)
    xp = np.zeros(scs.n_rows_padded, dtype)
    xp[scs.old_to_new_idx] = x
    return xp


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("sigma", [1, 1024])
def test_plain_matches_lane_tile_kernel(name, sigma):
    jscs = jax_scs(MATRICES[name](), 1024, sigma, np.float32)
    xp = permuted_x(jscs, 0, np.float32)
    y_jax = np.asarray(spmv_lane_tiles(
        build_device_lane_tiles(jscs), jnp.asarray(xp), interpret=True
    ))
    dev = build_device_scs(scs_from_reference(dataclasses.asdict(jscs)), CPU)
    y = spmv_scs(dev, torch.from_numpy(xp))
    assert y.dtype == torch.float32 and y.shape == (jscs.n_rows_padded,)
    rows = jscs.old_to_new_idx
    y_port, y_ref = y.numpy()[rows], y_jax[rows]
    scale = max(np.abs(y_ref).max(), 1e-30)
    assert np.abs(y_port - y_ref).max() / scale < 2e-5


@pytest.mark.parametrize("bs", [1, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plain_bf16_matches_lane_tile_kernel(name, bs):
    """hp: bf16 values, f32 x and sums; rowwise bs columns share one
    matrix stream in the lane-tile kernel (its bs loop)."""
    import ml_dtypes

    jscs = jax_scs(MATRICES[name](), 1024, 1, ml_dtypes.bfloat16)
    xs = np.random.default_rng(bs).standard_normal(
        (jscs.n_rows_padded, bs)).astype(np.float32)
    xs[np.setdiff1d(np.arange(jscs.n_rows_padded), jscs.old_to_new_idx)] = 0
    x = xs[:, 0] if bs == 1 else xs
    y_jax = np.asarray(spmv_lane_tiles(
        build_device_lane_tiles(jscs, dtype=ml_dtypes.bfloat16,
                                block_vec_size=bs),
        jnp.asarray(x), interpret=True))
    fields = dataclasses.asdict(jscs)
    fields["values"] = jscs.values.astype(np.float32)
    dev = build_device_scs(scs_from_reference(fields), CPU, torch.bfloat16)
    assert dev.values.dtype == torch.bfloat16
    y = spmv_scs(dev, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == x.shape
    rows = jscs.old_to_new_idx
    y_port, y_ref = y.numpy()[rows], y_jax[rows]
    assert np.abs(y_port - y_ref).max() / np.abs(y_ref).max() < 2e-5


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plain_f64_matches_df64_kernel(name):
    """-dp_emu: the port's native f64 against the TPU's (hi, lo) pair
    kernel in interpret mode, which is float-accurate there (its
    error-free transforms degrade off the chip)."""
    jscs = jax_scs(MATRICES[name](), 1024, 1, np.float64)
    xp = permuted_x(jscs, 2, np.float64)
    hi = xp.astype(np.float32)
    lo = (xp - hi.astype(np.float64)).astype(np.float32)
    jdev = build_device_lane_tiles(jscs, dtype=np.float64)
    assert jdev.df64
    pair = np.asarray(spmv_lane_tiles(jdev, jnp.asarray(np.stack([hi, lo], -1)),
                                      interpret=True))
    y_jax = pair[:, 0].astype(np.float64) + pair[:, 1].astype(np.float64)
    dev = build_device_scs(scs_from_reference(dataclasses.asdict(jscs)), CPU)
    y = spmv_scs(dev, torch.from_numpy(xp)).numpy()
    rows = jscs.old_to_new_idx
    assert np.abs(y[rows] - y_jax[rows]).max() / np.abs(y_jax).max() < 1e-6


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("C,sigma", [(1, 1), (32, 8), (1024, 1)])
def test_plain_f64_matches_spmv_reference(name, C, sigma):
    scs = scs_from_reference(
        dataclasses.asdict(jax_scs(MATRICES[name](), C, sigma, np.float64))
    )
    xp = permuted_x(scs, 1, np.float64)
    y = spmv_scs_plain(build_device_scs(scs, CPU), torch.from_numpy(xp))
    ref = scs.spmv_reference(xp)
    assert np.abs(y.numpy() - ref).max() / np.abs(ref).max() < 1e-13


@pytest.fixture
def small_dev():
    scs = scs_from_reference(
        dataclasses.asdict(jax_scs(jgen.tridiag(100), 32, 1, np.float32))
    )
    return build_device_scs(scs, CPU)


def test_wrapper_rejects_wrong_dtype(small_dev):
    with pytest.raises(TypeError, match="dtype"):
        spmv_scs(small_dev, torch.zeros(small_dev.n_rows_padded,
                                        dtype=torch.float16))


@pytest.mark.parametrize("shape", [(50,), (50, 2), ()])
def test_wrapper_rejects_wrong_shape(small_dev, shape):
    with pytest.raises(ValueError, match="1-D"):
        spmv_scs(small_dev, torch.zeros(shape, dtype=torch.float32))


def test_cpu_tensors_never_count_as_launches(small_dev):
    n0 = scs_spmv.launch_count()
    spmv_scs(small_dev, torch.ones(small_dev.n_rows_padded))
    assert scs_spmv.launch_count() == n0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_loaded", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library()


def fake_nvcc(tmp_path, fail_on=None):
    """An nvcc that logs its arguments, one line per call, and writes its
    -o file; it fails on a source named ``fail_on``."""
    calls = tmp_path / "calls.txt"
    tool = tmp_path / "nvcc"
    tool.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        + (f'case "$*" in *{fail_on}*) echo refused; exit 2;; esac\n'
           if fail_on else "")
        + 'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n')
    tool.chmod(0o755)
    return str(tool), calls


def test_build_runs_an_nvcc_per_source_then_links(monkeypatch, tmp_path):
    tool, calls = fake_nvcc(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: tool)
    sources = [tmp_path / f"{name}.cu" for name in ("a", "b", "c")]
    for src in sources:
        src.write_text("")
    out = tmp_path / "lib" / "lib.so"
    out.parent.mkdir()
    log, seconds = _build.compile_library(sources, out)
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in f" {ln} "]
    assert sorted(ln.split()[-1] for ln in compiles) == sorted(
        map(str, sources))
    assert all("arch=compute_90a,code=sm_90a" in ln for ln in compiles)
    (link,) = [ln for ln in lines if ln not in compiles]
    assert link.split()[:3] == ["-shared", "-o", str(out)]
    assert [p.rsplit("/", 1)[-1] for p in link.split()[3:]] == [
        "a.o", "b.o", "c.o"]
    assert set(seconds) == {"a.cu", "b.cu", "c.cu", "link"}
    assert out.read_text() == "built\n"
    assert list(out.parent.iterdir()) == [out]  # the objects are gone


def test_build_names_the_source_nvcc_refused(monkeypatch, tmp_path):
    tool, calls = fake_nvcc(tmp_path, fail_on="b.cu")
    monkeypatch.setattr(_build, "find_nvcc", lambda: tool)
    sources = [tmp_path / f"{name}.cu" for name in ("a", "b")]
    out = tmp_path / "lib.so"
    with pytest.raises(_build.KernelBuildError, match=r"b\.cu \(rc 2\)"):
        _build.compile_library(sources, out)
    assert not out.exists()
    assert not any("-shared" in ln for ln in calls.read_text().splitlines())


def test_cuda_source_exports_the_bound_entry_points():
    src = (_build.CSRC_DIR / "scs_spmv.cu").read_text()
    body = src.split('extern "C" {', 1)[1]
    for name in list(scs_spmv._ENTRY_POINTS.values()) + [
        "uspmv_cuda_error_string"
    ]:
        assert f"{name}(" in body
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
