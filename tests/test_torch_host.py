"""Host structures of uspmv_tpu_torch against the JAX package: COO and its
scalings, the generators, MatrixMarket I/O, SELL-C-sigma conversion, the
vector layouts and Config.validate must agree bit for bit on the same
inputs."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats import coo as jcoo
from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.formats.scs import permute_scs_cols as j_permute
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.io.mmio import read_mtx as j_read
from uspmv_tpu.io.mmio import write_mtx as j_write
from uspmv_tpu.ops import vectors as jvec

from uspmv_tpu_torch.config import Config as TConfig
from uspmv_tpu_torch.formats import coo as tcoo
from uspmv_tpu_torch.formats.scs import convert_to_scs as t_convert
from uspmv_tpu_torch.formats.scs import permute_scs_cols as t_permute
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.io.mmio import read_mtx as t_read
from uspmv_tpu_torch.io.mmio import write_mtx as t_write
from uspmv_tpu_torch.ops import vectors as tvec


def assert_same(a, b):
    """Dataclasses with equal fields; arrays equal in dtype and bits."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        x, y = da[k], db[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, k
            assert np.array_equal(x, y), k
        else:
            assert x == y, k


GENERATED = {
    "laplace3d(7)": lambda g: g.laplace3d(7),
    "random_banded(600,30,9)": lambda g: g.random_banded(600, 30, 9),
    "laplace2d(9,5)": lambda g: g.laplace2d(9, 5),
    "tridiag(50)": lambda g: g.tridiag(50),
    "fem_tet3d(6)": lambda g: g.fem_tet3d(6),
    "wide_spectrum(6)": lambda g: g.wide_spectrum(6),
    "fem_tet3d(5,2,0.5,3)": lambda g: g.fem_tet3d(5, 2, 0.5, 3),
    "wide_spectrum(4,3.0)": lambda g: g.wide_spectrum(4, 3.0),
    # the zero-locality / heavy-tail classes, with the arguments and seeds
    # of the JAX package's bench.py at a small n, and others
    "random_imbalanced(3000,8)": lambda g: g.random_imbalanced(3000, 8),
    "banded_imbalanced(3000,64,8,seed=7)": lambda g: g.banded_imbalanced(
        3000, bandwidth=64, avg_nnz_per_row=8, seed=7),
    "powerlaw_cols(3000,8)": lambda g: g.powerlaw_cols(3000, 8),
    "random_imbalanced(500,5,1.1,3)": lambda g: g.random_imbalanced(
        500, 5, 1.1, 3),
    "banded_imbalanced(40000,16,4,0.5,11)": lambda g: g.banded_imbalanced(
        40000, 16, 4, 0.5, 11),
    "powerlaw_cols(700,3,1.5,2)": lambda g: g.powerlaw_cols(700, 3, 1.5, 2),
}


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generators_bit_equal(name):
    make = GENERATED[name]
    assert_same(make(jgen), make(tgen))


@pytest.mark.parametrize("spec", ["Laplace3D,5", "RandomBanded,300,20,7",
                                  "Tridiag,40", "Laplace2D,6", "FemTet3D,4",
                                  "WideSpectrum,4", "RandomImbalanced,400,6",
                                  "BandedImbalanced,900,32,6",
                                  "PowerLawCols,500,5"])
def test_generate_matrix_spec_bit_equal(spec):
    assert_same(jgen.generate_matrix(spec), tgen.generate_matrix(spec))


def test_generate_matrix_unported_name_raises():
    with pytest.raises(ValueError, match="unknown generator 'NoSuchModel'"):
        tgen.generate_matrix("NoSuchModel,5")


def test_mtx_io_bit_equal(tmp_path):
    m = tgen.random_banded(600, 30, 9)
    t_path, j_path = tmp_path / "t.mtx", tmp_path / "j.mtx"
    t_write(str(t_path), tcoo.MtxData.from_arrays(m.I, m.J, m.values,
                                                  m.n_rows, m.n_cols))
    j_write(str(j_path), jcoo.MtxData.from_arrays(m.I, m.J, m.values,
                                                  m.n_rows, m.n_cols))
    assert t_path.read_bytes() == j_path.read_bytes()
    assert_same(j_read(str(t_path), native=False), t_read(str(t_path)))


def test_read_mtx_symmetric_pattern_bit_equal(tmp_path):
    path = tmp_path / "sym.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate pattern symmetric\n"
        "% comment\n4 4 5\n1 1\n2 1\n3 2\n4 4\n4 3\n"
    )
    assert_same(j_read(str(path), native=False), t_read(str(path)))


def test_mtxdata_methods_bit_equal():
    jm, tm = jgen.random_banded(400, 25, 7), tgen.random_banded(400, 25, 7)
    perm = np.random.default_rng(3).permutation(jm.n_rows).astype(np.int32)
    inv = jcoo.generate_inv_perm(perm)
    assert np.array_equal(inv, tcoo.generate_inv_perm(perm))
    assert_same(jm.permute(perm, inv), tm.permute(perm, inv))
    assert_same(jm.permute(perm, inv).sort_by_row(),
                tm.permute(perm, inv).sort_by_row())
    assert_same(jm.astype(np.float32), tm.astype(np.float32))
    assert_same(jm.copy(), tm.copy())
    assert np.array_equal(jm.row_counts(), tm.row_counts())
    assert (jcoo.extract_matrix_min_mean_max(jm)
            == tcoo.extract_matrix_min_mean_max(tm))
    v = np.arange(jm.n_rows, dtype=np.float64)
    assert np.array_equal(jcoo.apply_permutation(v, perm),
                          tcoo.apply_permutation(v, perm))
    sp = tm.to_scipy()
    assert_same(jcoo.MtxData.from_scipy(sp), tcoo.MtxData.from_scipy(sp))
    assert (abs(sp - jm.to_scipy())).max() == 0


SCALED = {
    "wide_spectrum(5)": lambda g: g.wide_spectrum(5),
    "fem_tet3d(4)": lambda g: g.fem_tet3d(4),
    "wide_spectrum(4)-f32":
        lambda g: g.wide_spectrum(4).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(SCALED))
def test_scaling_bit_equal(name):
    jm, tm = SCALED[name](jgen), SCALED[name](tgen)
    for f in ("extract_largest_row_elems", "extract_largest_col_elems"):
        a, b = getattr(jcoo, f)(jm), getattr(tcoo, f)(tm)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    jr, tr = jm.copy(), tm.copy()
    lr = jcoo.extract_largest_row_elems(jm)
    jcoo.scale_matrix_rows(jr, lr)
    tcoo.scale_matrix_rows(tr, lr)
    assert_same(jr, tr)
    lc = jcoo.extract_largest_col_elems(jm)
    jcoo.scale_matrix_cols(jr, lc)
    tcoo.scale_matrix_cols(tr, lc)
    assert_same(jr, tr)
    je, te = jm.copy(), tm.copy()
    for a, b in zip(jcoo.equilibrate_matrix(je), tcoo.equilibrate_matrix(te)):
        assert np.array_equal(a, b)
    assert_same(je, te)
    jj, tj = jm.copy(), tm.copy()
    assert np.array_equal(jcoo.jacobi_scale_matrix(jj),
                          tcoo.jacobi_scale_matrix(tj))
    assert_same(jj, tj)


def test_jacobi_scale_zero_diagonal_raises_like_jax():
    m = tgen.tridiag(10)
    keep = ~((m.I == m.J) & (m.I == 3))
    for mod in (jcoo, tcoo):
        z = mod.MtxData.from_arrays(m.I[keep], m.J[keep], m.values[keep],
                                    10, 10)
        with pytest.raises(ValueError, match="zero diagonal"):
            mod.jacobi_scale_matrix(z)


@pytest.mark.parametrize("C", [1, 4, 32, 1024])
@pytest.mark.parametrize("sigma", [1, 8, 512])
def test_convert_and_permute_scs_bit_equal(C, sigma):
    jm, tm = jgen.random_banded(600, 30, 9), tgen.random_banded(600, 30, 9)
    js = j_convert(jm.astype(np.float32), C, sigma, native=False)
    ts = t_convert(tm.astype(np.float32), C, sigma)
    assert_same(js, ts)
    perm = np.arange(ts.n_rows_padded, dtype=np.int32)
    perm[: ts.n_rows] = ts.old_to_new_idx
    j_permute(js, perm)
    t_permute(ts, perm)
    assert_same(js, ts)
    assert js.beta == ts.beta
    assert np.array_equal(js.flat_row_idx(), ts.flat_row_idx())


def test_convert_to_scs_fixed_permutation_bit_equal():
    jm, tm = jgen.laplace3d(7), tgen.laplace3d(7)
    # 343 rows into the 352 slots of 11 chunks of C=32
    fixed = np.random.default_rng(5).permutation(352)[: jm.n_rows]
    js = j_convert(jm, 32, 1, fixed_permutation=fixed, native=False)
    ts = t_convert(tm, 32, 1, fixed_permutation=fixed)
    assert_same(js, ts)


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("layout", ["rowwise", "colwise"])
def test_block_vectors_bit_equal(bs, layout):
    rng = np.random.default_rng(bs)
    n, n_pad = 300, 320
    perm = rng.permutation(n_pad)[:n].astype(np.int32)
    stats = (0.25, 1.5, 2.75)
    for kw in ({}, {"random_init_x": True}, {"mean_init_x": True}):
        kw = dict(kw, block_vec_size=bs, vector_layout=layout)
        jx = jvec.init_x_host(JConfig(**kw), n, stats)
        tx = tvec.init_x_host(TConfig(**kw), n, stats)
        assert tx.shape == (n, bs)
        assert jx.dtype == tx.dtype and np.array_equal(jx, tx)
    x_in = rng.standard_normal((n, bs))
    cfg = dict(block_vec_size=bs, vector_layout=layout)
    tx = tvec.init_x_host(TConfig(**cfg), n, x_in=x_in, dtype=np.float32)
    jx = jvec.init_x_host(JConfig(**cfg), n, x_in=x_in, dtype=np.float32)
    jd = jvec.to_device_layout(jx, layout, n_pad, perm)
    td = tvec.to_device_layout(tx, layout, n_pad, perm)
    assert td.shape == ((n_pad, bs) if layout == "rowwise" else (bs, n_pad))
    assert td.flags.c_contiguous and np.array_equal(jd, td)
    back = tvec.from_device_layout(td, layout, perm)
    assert np.array_equal(jvec.from_device_layout(jd, layout, perm), back)
    assert np.array_equal(back, tx)


def test_vectors_bit_equal():
    rng = np.random.default_rng(11)
    n, n_pad = 500, 512
    perm = rng.permutation(n_pad)[:n].astype(np.int32)
    stats = (0.5, 1.75, 3.0)
    for kw in ({}, {"random_init_x": True}, {"mean_init_x": True}):
        jx = jvec.init_x_host(JConfig(**kw), n, stats)
        tx = tvec.init_x_host(TConfig(**kw), n, stats)
        assert jx.dtype == tx.dtype and np.array_equal(jx, tx)
    x_in = rng.standard_normal(n)
    jx = jvec.init_x_host(JConfig(), n, x_in=x_in, dtype=np.float32)
    tx = tvec.init_x_host(TConfig(), n, x_in=x_in, dtype=np.float32)
    assert tx.dtype == np.float32 and np.array_equal(jx, tx)
    jd = jvec.to_device_layout(jx, "colwise", n_pad, perm)
    td = tvec.to_device_layout(tx, "colwise", n_pad, perm)
    assert np.array_equal(jd, td)
    assert np.array_equal(jvec.from_device_layout(jd, "colwise", perm),
                          tvec.from_device_layout(td, "colwise", perm))
    assert np.array_equal(tvec.from_device_layout(td, "colwise", perm), tx)


BAD_CONFIGS = {
    "format": dict(kernel_format="ell"),
    "value_type": dict(value_type="qp"),
    "mode": dict(mode="x"),
    "chunk": dict(chunk_size=0),
    "layout": dict(vector_layout="diag"),
    "seg": dict(seg_method="seg-foo"),
    "comm": dict(comm_mode="carrier-pigeon"),
    "impl": dict(impl="magic"),
    "dp_emu_sp": dict(value_type="sp", dp_emulation=True),
    "bs": dict(block_vec_size=0),
    "ap_th2": dict(value_type="ap[dp_sp_hp]", ap_threshold_1=0.1,
                   ap_threshold_2=0.5),
    "crs_c": dict(kernel_format="crs", chunk_size=4),
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_config_validate_rejects_like_jax(name):
    kw = BAD_CONFIGS[name]
    with pytest.raises(ValueError):
        JConfig(**kw).validate()
    with pytest.raises(ValueError):
        TConfig(**kw).validate()


def test_config_backend_and_dtypes():
    import torch

    TConfig().validate()
    assert TConfig().backend == "cuda"
    with pytest.raises(ValueError, match="backend"):
        TConfig(backend="tpu").validate()
    assert TConfig(value_type="hp").working_dtype() == torch.float32
    assert TConfig(value_type="ap[sp_hp]").working_dtype() == torch.float32
    assert TConfig(value_type="ap[dp_hp]").working_dtype() == torch.float64
    assert TConfig(value_type="dp", dp_emulation=True).working_dtype() \
        == torch.float64
    assert TConfig(value_type="dp").working_dtype() == torch.float64
    assert TConfig(value_type="ap[sp_hp]").ap_precisions == ("sp", "hp")
    from uspmv_tpu_torch.config import dtype_for

    assert dtype_for("hp") == torch.bfloat16
