"""The port's binding of the native host library (uspmv_tpu_torch/native.py),
built here with g++ from native/uspmv_host.cpp: read_mtx and convert_to_scs
through the C++ entries, bit-equal to the port's Python paths and to the
JAX package's native entries; native=True refuses to fall back."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu import native as jnative
from uspmv_tpu.formats.coo import MtxData as JMtxData
from uspmv_tpu.io.mmio import read_mtx as j_read_mtx

from uspmv_tpu_torch import native
from uspmv_tpu_torch.config import host_values
from uspmv_tpu_torch.formats.scs import convert_to_scs
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.io.mmio import read_mtx, write_mtx


def assert_same(a, b):
    """Every field of two dataclasses equal; arrays by dtype and bits."""
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, np.ndarray):
            assert u.dtype == v.dtype and u.shape == v.shape, f.name
            assert u.tobytes() == v.tobytes(), f.name
        else:
            assert u == v, f.name


@pytest.fixture(scope="module")
def lib():
    lib = native.load(required=True)
    assert native.library_path().exists()
    assert native.library_path().parent.name == "uspmv_tpu_torch"
    return lib


def write_text(path, text):
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("kind", ["general", "symmetric", "skew", "pattern",
                                  "comments", "generated"])
def test_read_mtx_native_equals_python(lib, tmp_path, kind):
    body = {
        "general": ("%%MatrixMarket matrix coordinate real general\n"
                    "4 4 5\n3 1 2.5\n1 1 1.0\n4 2 -3\n2 2 7e-3\n1 4 0.5\n"),
        "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                      "3 3 4\n1 1 2\n2 1 -1\n3 2 -1\n3 3 2\n"),
        "skew": ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                 "3 3 2\n2 1 1.5\n3 1 -2\n"),
        "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                    "3 3 3\n1 2\n3 3\n2 1\n"),
        "comments": ("%%MatrixMarket matrix coordinate integer general\n"
                     "% a comment\n\n%another\n2 2 2\n2 1 4\n1 2 -4\n"),
    }
    if kind == "generated":
        path = str(tmp_path / "m.mtx")
        write_mtx(path, tgen.random_banded(3000, 40, 9))
    else:
        path = write_text(tmp_path / "m.mtx", body[kind])
    a = read_mtx(path, native=True)
    b = read_mtx(path, native=False)
    assert_same(a, b)
    assert_same(read_mtx(path), b)  # the default takes the library
    # and the JAX package's native reader, field by field
    j = j_read_mtx(path, native=True)
    assert_same(JMtxData(**dataclasses.asdict(a)), j)


def test_read_mtx_native_errors_alike(lib, tmp_path):
    path = write_text(tmp_path / "r.mtx",
                      "%%MatrixMarket matrix coordinate real general\n"
                      "2 3 1\n1 1 1\n")
    with pytest.raises(ValueError) as err:
        read_mtx(path, native=True)
    with pytest.raises(ValueError) as jerr:
        j_read_mtx(path, native=True)
    assert str(err.value) == str(jerr.value)
    a = read_mtx(path, require_square=False, native=True)
    assert_same(a, read_mtx(path, require_square=False, native=False))


CONVERT = {
    "laplace-c1": (lambda: tgen.laplace2d(20), 1, 1, None),
    "banded-c32-s64": (lambda: tgen.random_banded(2000, 30, 7), 32, 64, None),
    "imbalanced-c8-s7": (lambda: tgen.random_imbalanced(1500, 6, seed=2), 8,
                         7, None),
    "stokes-c1024": (lambda: tgen.stokes_saddle(5), 1024, 1, None),
    "hubbard-c4-f32": (lambda: tgen.generate_matrix(
        "Hubbard,n_sites=7,n_fermions=3,U=1.3"), 4, 16, np.float32),
}


@pytest.mark.parametrize("case", sorted(CONVERT))
def test_convert_to_scs_native_equals_python(lib, case):
    make, C, sigma, dtype = CONVERT[case]
    m = make()
    for mtx in (m, dataclasses.replace(m, values=host_values(m.values, "sp")),
                dataclasses.replace(m, values=host_values(m.values, "hp"))):
        a = convert_to_scs(mtx, C, sigma, dtype=dtype, native=True)
        b = convert_to_scs(mtx, C, sigma, dtype=dtype, native=False)
        assert_same(a, b)
        assert_same(convert_to_scs(mtx, C, sigma, dtype=dtype), b)
        # a fixed permutation, as the adaptive precisions take
        perm = a.old_to_new_idx[::-1].copy()
        assert_same(convert_to_scs(mtx, C, sigma, fixed_permutation=perm,
                                   native=True),
                    convert_to_scs(mtx, C, sigma, fixed_permutation=perm,
                                   native=False))
        # and the JAX package's native converter
        j = jnative.convert_to_scs_native(
            JMtxData(**dataclasses.asdict(mtx)), C, sigma, dtype=dtype)
        for f in dataclasses.fields(a):
            u, v = getattr(a, f.name), getattr(j, f.name)
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype and np.array_equal(u, v), f.name
            else:
                assert u == v, f.name


def test_convert_errors_alike(lib):
    m = tgen.laplace2d(6)
    with pytest.raises(ValueError, match="shorter than n_rows"):
        convert_to_scs(m, 4, 1, fixed_permutation=np.arange(3), native=True)
    with pytest.raises(ValueError, match="C and sigma"):
        convert_to_scs(m, 0, 1, native=True)


def test_native_true_without_a_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_warned", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    m = tgen.laplace2d(5)
    with pytest.raises(native.NativeUnavailableError, match="no-such"):
        convert_to_scs(m, 4, 1, native=True)
    with pytest.raises(native.NativeUnavailableError):
        read_mtx(str(tmp_path / "none.mtx"), native=True)
    # the default falls back to the Python paths, with one warning
    with pytest.warns(RuntimeWarning, match="no-such"):
        assert native.available() is False
    assert_same(convert_to_scs(m, 4, 1), convert_to_scs(m, 4, 1,
                                                         native=False))
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


def test_disable_native_env(monkeypatch, lib):
    monkeypatch.setenv("USPMV_DISABLE_NATIVE", "1")
    assert native.load() is None and not native.available()
    with pytest.raises(native.NativeUnavailableError, match="DISABLE"):
        native.load(required=True)
    m = tgen.laplace2d(5)
    assert_same(convert_to_scs(m, 4, 1), convert_to_scs(m, 4, 1,
                                                         native=False))


def test_binding_never_touches_the_jax_library():
    assert "uspmv_tpu/native" not in str(native.library_path())
    assert native.SOURCE.name == "uspmv_host.cpp"
    assert native.SOURCE.parent.name == "native"
