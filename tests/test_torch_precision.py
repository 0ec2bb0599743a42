"""Adaptive precision on the host: uspmv_tpu_torch's hp rounding, its
partitioner and the per-precision SELL-C-sigma structs against the JAX
package, bit for bit (hp values compared as float32; numpy has no bfloat16,
so the port holds them as float32 arrays of bf16-rounded values)."""

import warnings

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats import coo as jcoo
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.precision import partition as jpart
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch.config import Config, host_values
from uspmv_tpu_torch.formats import coo as tcoo
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.device_format import GROUP_ROWS, group_table
from uspmv_tpu_torch.precision import partition as tpart
from uspmv_tpu_torch.runtime.operator import SpmvOperator

SPLITS = {
    "ap[dp_sp]": (1e-2, 0.0),
    "ap[dp_hp]": (1e-2, 0.0),
    "ap[sp_hp]": (1e-2, 0.0),
    "ap[dp_sp_hp]": (1e-2, 1e-5),
}


def as_f32(values):
    """JAX hp values (ml_dtypes.bfloat16) as float32; others unchanged."""
    if values.dtype == np.dtype(ml_dtypes.bfloat16):
        return values.astype(np.float32)
    return values


def test_hp_rounding_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.standard_normal(200_000),
        np.power(10.0, -rng.random(100_000) * 40),
        [1 + 2.0**-8 + 2.0**-40, 1 + 2.0**-8, 0.0, -0.0, 1e-45],
    ])
    for src in (v, v.astype(np.float32)):
        got = host_values(src, "hp")
        want = src.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert host_values(v, "sp").dtype == np.float32
    # values already in the target dtype come back as they are, uncopied
    assert host_values(v, "dp") is v
    f32 = v.astype(np.float32)
    assert host_values(f32, "sp") is f32


def scaled(gen_mod, coo_mod, equilibrate):
    m = gen_mod.wide_spectrum(5)
    lr = lc = None
    if equilibrate:
        lr, lc = coo_mod.equilibrate_matrix(m)
    return m, lr, lc


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("equilibrate", [False, True])
@pytest.mark.parametrize("value_type", sorted(SPLITS))
def test_partition_bit_equal(value_type, equilibrate, dropout):
    th1, th2 = SPLITS[value_type]
    jm, jlr, jlc = scaled(jgen, jcoo, equilibrate)
    tm, tlr, tlc = scaled(tgen, tcoo, equilibrate)
    kw = dict(equilibrate=equilibrate, dropout=dropout,
              dropout_threshold=1e-6)
    jsubs, jdrop = jpart.partition_precisions(
        jm, value_type, th1, th2, largest_row_elems=jlr,
        largest_col_elems=jlc, **kw)
    tsubs, tdrop = tpart.partition_precisions(
        tm, value_type, th1, th2, largest_row_elems=tlr,
        largest_col_elems=tlc, **kw)
    assert tdrop == jdrop and (tdrop > 0) == dropout
    assert list(tsubs) == list(jsubs) == list(value_type[3:-1].split("_"))
    for p in jsubs:
        a, b = jsubs[p], tsubs[p]
        assert b.nnz == a.nnz > 0, p
        assert np.array_equal(a.I, b.I) and np.array_equal(a.J, b.J), p
        va = as_f32(a.values)
        assert va.dtype == b.values.dtype, p
        assert np.array_equal(va, b.values), p
        assert (a.n_rows, a.n_cols, a.is_sorted) == (b.n_rows, b.n_cols,
                                                     b.is_sorted)


def test_partition_rejects_like_jax():
    m = tgen.tridiag(20)
    for mod in (jpart, tpart):
        with pytest.raises(ValueError, match="adaptive"):
            mod.partition_precisions(m, "sp", 1.0)
        with pytest.raises(ValueError, match="unknown"):
            mod.partition_precisions(m, "ap[hp_dp]", 1.0)
        with pytest.raises(ValueError, match="ap_threshold_2"):
            mod.partition_precisions(m, "ap[dp_sp_hp]", 1.0, 2.0)
        with pytest.raises(ValueError, match="largest"):
            mod.partition_precisions(m, "ap[dp_sp]", 1.0, equilibrate=True)


@pytest.mark.parametrize("tol", [1e-8, 3e-3])
def test_ap_threshold_from_norm_equal(tol):
    assert (tpart.ap_threshold_from_norm(tgen.wide_spectrum(4), tol)
            == jpart.ap_threshold_from_norm(jgen.wide_spectrum(4), tol))


def jax_and_port(gen, args, **kw):
    # mixed_tiles=False: the SCS arrays are compared, whatever their beta
    cfg = dict(kernel_format="scs", chunk_size=1024, sigma=1, backend="cpu",
               mixed_tiles=False, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jop = JOperator.from_mtx(JConfig(**cfg), getattr(jgen, gen)(*args))
    return jop, SpmvOperator.from_mtx(Config(**cfg),
                                      getattr(tgen, gen)(*args))


OPERATORS = {
    "hp-laplace3d(10)": ("laplace3d", (10,), dict(value_type="hp")),
    "hp-wide_spectrum(5)": ("wide_spectrum", (5,), dict(value_type="hp")),
    "ap[dp_sp_hp]-wide_spectrum(5)": (
        "wide_spectrum", (5,),
        dict(value_type="ap[dp_sp_hp]", ap_threshold_1=1e-2,
             ap_threshold_2=1e-5)),
    "ap[dp_hp]-laplace3d(10)": ("laplace3d", (10,),
                                dict(value_type="ap[dp_hp]",
                                     ap_threshold_1=2.44)),
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_scs_bit_equal(name):
    """Each precision's SCS of the port's operator equals the JAX
    operator's (values as float32 for hp), after the column permutation;
    every sub-matrix shares the primary permutation."""
    gen, args, kw = OPERATORS[name]
    jop, op = jax_and_port(gen, args, **kw)
    assert list(op.scs) == list(jop.scs)
    primary = next(iter(op.scs.values()))
    for p, js in jop.scs.items():
        ts = op.scs[p]
        for f in ("chunk_ptrs", "chunk_lengths", "col_idxs",
                  "old_to_new_idx", "new_to_old_idx"):
            assert np.array_equal(getattr(js, f), getattr(ts, f)), (p, f)
        assert np.array_equal(as_f32(js.values), ts.values), p
        assert (ts.C, ts.sigma, ts.n_elements, ts.nnz) == (
            js.C, js.sigma, js.n_elements, js.nnz)
        assert np.array_equal(ts.old_to_new_idx, primary.old_to_new_idx)
        dev = op.devs[p]
        assert dev.values.dtype == {"dp": torch.float64, "sp": torch.float32,
                                    "hp": torch.bfloat16}[p]
        assert np.array_equal(dev.values.float().numpy(),
                              ts.values.astype(np.float32))
        # 2 B per hp value, 4 per sp, 8 per dp, and an int32 column, for
        # each slot below its group's length (the table and the slots read
        # from the JAX row counts); chunk_ptrs and a uint8 length per group
        table, read = group_table(js)
        assert np.array_equal(dev.group_lengths.numpy(), table)
        size = dev.values.element_size() + 4
        if not table.size:
            # the chunk form: every slot, and chunk_ptrs/lengths
            assert read == ts.n_elements
            assert dev.stream_bytes() == ts.n_elements * size + 4 * (
                2 * ts.n_chunks + 1)
            continue
        assert table.dtype == np.uint8
        assert table.size == ts.n_rows_padded // GROUP_ROWS
        assert dev.stream_bytes() == read * size + 4 * (ts.n_chunks + 1) + (
            table.size)


@pytest.mark.parametrize("C,sigma", [(32, 64), (1024, 1), (4, 16)])
def test_ap_subs_share_primary_permutation(C, sigma):
    """As tests/test_kernels.py holds the JAX operator to it: every
    sub-matrix's old_to_new_idx equals the primary's."""
    cfg = Config(kernel_format="scs", chunk_size=C, sigma=sigma,
                 value_type="ap[dp_sp_hp]", ap_threshold_1=1e-2,
                 ap_threshold_2=1e-5, backend="cpu")
    op = SpmvOperator.from_mtx(cfg, tgen.wide_spectrum(4))
    primary = op.scs["dp"]
    assert primary.nnz and op.scs["sp"].nnz and op.scs["hp"].nnz
    for p in ("sp", "hp"):
        assert np.array_equal(op.scs[p].old_to_new_idx,
                              primary.old_to_new_idx)
