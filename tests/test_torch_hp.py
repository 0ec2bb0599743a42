"""hp (bf16 values, f32 x and sums) and ap[sp_hp] through uspmv_tpu_torch's
SpmvOperator against the JAX package's on the CPU. The port runs its plain
PyTorch version there; the JAX package runs its lane-tile kernel in Pallas
interpret mode (re-tiled into 1024-row chunks for C=32, sigma=64).

Tolerance 1e-5 x max|y|: both round the values to bf16 identically (host
bit-equality, tests/test_torch_precision.py) and sum in f32, in another
order."""

import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.vectors import init_x_host
from uspmv_tpu_torch.runtime.operator import SpmvOperator
from uspmv_tpu_torch.runtime.validate import validate_solve

# matrix -> (generator, args, ap_threshold_1 of ap[sp_hp])
MATRICES = {
    "laplace3d(12)": ("laplace3d", (12,), 2.44),
    "random_banded(3000,40,9)": ("random_banded", (3000, 40, 9), 1.0),
    "wide_spectrum(6)": ("wide_spectrum", (6,), 1e-2),
}
FORMATS = {"C1024-s1": (1024, 1), "C32-s64": (32, 64)}
TOL = 1e-5


def config(cls, value_type, th, C, sigma):
    return cls(kernel_format="scs", chunk_size=C, sigma=sigma,
               value_type=value_type, ap_threshold_1=th, backend="cpu",
               mixed_tiles=False)  # the SELL-C-sigma stream at any beta


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("value_type", ["hp", "ap[sp_hp]"])
def test_hp_matches_jax_operator(value_type, name, fmt):
    gen, args, th = MATRICES[name]
    C, sigma = FORMATS[fmt]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jop = JOperator.from_mtx(config(JConfig, value_type, th, C, sigma),
                                 getattr(jgen, gen)(*args))
    op = SpmvOperator.from_mtx(config(Config, value_type, th, C, sigma),
                               getattr(tgen, gen)(*args))
    assert op.nnz_per_precision() == jop.nnz_per_precision()
    assert all(n > 0 for n in op.nnz_per_precision().values())
    assert op.impl_name() == f"torch-plain-scs-{value_type}"
    x = np.random.default_rng(3).standard_normal(op.n_rows)
    xd = op.make_x(x)
    assert xd.dtype == op.working_dtype and str(xd.dtype) == "torch.float32"
    y_jax = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    y = op.to_host(op.spmv(xd))
    assert y.dtype == y_jax.dtype == np.float32 and y.shape == y_jax.shape
    assert np.abs(y - y_jax).max() <= TOL * np.abs(y_jax).max()


@pytest.mark.parametrize("value_type", ["hp", "ap[sp_hp]"])
@pytest.mark.parametrize("name", ["laplace3d(12)", "wide_spectrum(6)"])
def test_hp_validate_solve_ok(value_type, name):
    gen, args, th = MATRICES[name]
    mtx = getattr(tgen, gen)(*args)
    op = SpmvOperator.from_mtx(config(Config, value_type, th, 1024, 1), mtx)
    x0 = init_x_host(op.config, op.n_rows, op.matrix_stats)
    _, y = op.solve(op.make_x(x0), 5)
    rep = validate_solve(mtx, x0, op.to_host(y), 5, value_type=value_type,
                         hp_nnz_fraction=op.hp_nnz_fraction())
    assert rep.flag == "OK", rep.summary()
