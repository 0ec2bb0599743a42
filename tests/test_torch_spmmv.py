"""Block vectors (SpMMV) through uspmv_tpu_torch against the JAX package
on the CPU, and the layouts and accumulate form of the plain version that
the CUDA kernel is checked against on the card.

Tolerances per column, x max|y| of that column: 1e-5 for f32 sums (the
JAX lane-tile kernel in Pallas interpret mode sums in another order),
1e-12 for f64 (its XLA path)."""

import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.formats.scs import permute_scs_cols as j_permute
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator

from uspmv_tpu_torch import cli
from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.formats.scs import scs_from_reference
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops import scs_spmv
from uspmv_tpu_torch.ops.device_format import (
    VECTORS_PER_PASS,
    build_device_scs,
    vector_pass_count,
)
from uspmv_tpu_torch.ops.scs_spmv import spmv_scs
from uspmv_tpu_torch.ops.vectors import init_x_host
from uspmv_tpu_torch.runtime.bench import bench_spmv
from uspmv_tpu_torch.runtime.operator import SpmvOperator
from uspmv_tpu_torch.runtime.validate import validate_solve

TOL = {"sp": 1e-5, "dp": 1e-12, "ap[dp_sp]": 1e-12}
CASES = {
    f"{vt}-bs{bs}-{layout}": dict(value_type=vt, block_vec_size=bs,
                                  vector_layout=layout)
    for vt in ("sp", "dp") for bs in (4, 8)
    for layout in ("rowwise", "colwise")
}
CASES["ap[dp_sp]-bs4-rowwise"] = dict(
    value_type="ap[dp_sp]", ap_threshold_1=1.0, block_vec_size=4,
    vector_layout="rowwise")
# two passes of 8 in either layout, and a colwise block of 3 (guarded)
CASES.update({
    f"sp-bs{bs}-{layout}": dict(value_type="sp", block_vec_size=bs,
                                vector_layout=layout)
    for bs, layout in ((16, "rowwise"), (16, "colwise"), (3, "colwise"))})
# the port's rows as packed row groups (one read of the matrix for every
# vector), held against the JAX operator's default tier
PORT_ONLY = dict(mixed_tiles=True, split_rows_threshold=-1)
CASES.update({
    f"sp-bs{bs}-{layout}-packed": dict(value_type="sp", block_vec_size=bs,
                                       vector_layout=layout, **PORT_ONLY)
    for bs, layout in ((16, "colwise"), (4, "rowwise"))})


def config(cls, **kw):
    return cls(**{"kernel_format": "scs", "chunk_size": 1024, "sigma": 1,
                  "backend": "cpu", **kw})


def per_column_rel(y, ref):
    return max(np.abs(y[:, v] - ref[:, v]).max() / np.abs(ref[:, v]).max()
               for v in range(ref.shape[1]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmmv_matches_jax_operator(name):
    kw = CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jop = JOperator.from_mtx(
            config(JConfig, **{k: v for k, v in kw.items()
                               if k not in PORT_ONLY}),
            jgen.random_banded(3000, 40, 9))
    op = SpmvOperator.from_mtx(config(Config, **kw),
                               tgen.random_banded(3000, 40, 9))
    bs, layout = kw["block_vec_size"], kw["vector_layout"]
    x = np.random.default_rng(bs).standard_normal((op.n_rows, bs))
    xd = op.make_x(x)
    assert xd.shape == ((op.n_rows_padded, bs) if layout == "rowwise"
                        else (bs, op.n_rows_padded))
    y = op.to_host(op.spmv(xd))
    ref = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert y.shape == ref.shape == (op.n_rows, bs) and y.dtype == ref.dtype
    assert per_column_rel(y, ref) <= TOL[kw["value_type"]]
    assert op.flops_per_spmv() == jop.flops_per_spmv()
    # the SELL kernel reads the matrix once per 8 vectors in either
    # layout, the packed kernel once for all of them
    packed = kw.get("mixed_tiles", False)
    assert op.is_packed() == packed
    passes = 1 if packed else vector_pass_count(bs)
    assert op.matrix_passes(packed) == passes
    assert op.matrix_passes(True) == 1
    xw = xd.element_size()
    assert op.bytes_per_spmv() == passes * sum(
        d.stream_bytes() for d in op.devs.values()
    ) + 2 * op.n_rows_padded * bs * xw


# heavy rows split into pieces: random_imbalanced(2000, 8) at threshold 8
# has parents of up to 62 pieces, so long parents (more than 8 pieces,
# several records meeting in slots) beside short ones
SPLIT_CASES = {
    f"{vt}-bs{bs}-{layout}-split": dict(
        value_type=vt, block_vec_size=bs, vector_layout=layout,
        split_rows_threshold=8, mixed_tiles=False)
    for vt in ("sp", "dp") for bs in (4, 8, 16)
    for layout in ("rowwise", "colwise")}


@pytest.fixture(scope="module")
def imbalanced_pair():
    return jgen.random_imbalanced(2000, 8), tgen.random_imbalanced(2000, 8)


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_spmmv_matches_jax_operator(name, imbalanced_pair):
    """Block vectors through the SELL-C-sigma rows and the heavy-row pieces
    (C=32, sigma=64) against the JAX operator, which sorts the same
    virtual rows into its SCS; the pieces' bytes count once per pass of 8
    vectors, their long parents' slots once per vector."""
    kw = SPLIT_CASES[name]
    jm, tm = imbalanced_pair
    cfg = dict(kw, chunk_size=32, sigma=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jop = JOperator.from_mtx(config(JConfig, **cfg), jm)
        op = SpmvOperator.from_mtx(config(Config, **cfg), tm)
    assert op.impl_name().startswith("torch-plain-scs+pieces")
    (pc,) = op.pieces.values()
    assert pc.longs.shape[0] > 0 and (pc.records[:, 3] < 0).any()
    bs, layout = kw["block_vec_size"], kw["vector_layout"]
    x = np.random.default_rng(bs).standard_normal((op.n_rows, bs))
    y = op.to_host(op.spmv(op.make_x(x)))
    ref = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert y.shape == ref.shape == (op.n_rows, bs) and y.dtype == ref.dtype
    assert per_column_rel(y, ref) <= TOL[kw["value_type"]]
    passes = vector_pass_count(bs)
    assert pc.vector_bytes() > 0
    pieces = passes * pc.pass_bytes() + bs * pc.vector_bytes()
    assert pc.stream_bytes(bs) == pieces < bs * pc.stream_bytes()
    assert op.bytes_per_spmv() == passes * sum(
        d.stream_bytes() for d in op.devs.values()
    ) + pieces + 2 * op.n_rows_padded * bs * op.make_x(x).element_size()


@pytest.mark.parametrize("bs", list(range(1, 18)) + [64, 65535])
def test_vector_passes_cover_each_vector_once(bs):
    passes = scs_spmv.vector_passes(bs)
    assert [v for v0, k in passes for v in range(v0, v0 + k)] == list(
        range(bs))
    assert all(1 <= k <= VECTORS_PER_PASS for _, k in passes)
    # the grid rows of the SELL kernel (colwise) and the pieces kernel
    # (either layout): vectors 8p .. 8p + 7 in row p
    assert [v0 for v0, _ in passes] == [
        VECTORS_PER_PASS * p for p in range(len(passes))]
    assert len(passes) == vector_pass_count(bs)


@pytest.mark.parametrize("layout", ["rowwise", "colwise"])
@pytest.mark.parametrize("value_type", ["sp", "hp", "ap[dp_sp_hp]"])
def test_spmmv_validate_solve_ok(value_type, layout):
    mtx = tgen.laplace3d(10)
    op = SpmvOperator.from_mtx(
        config(Config, value_type=value_type, ap_threshold_1=2.44,
               ap_threshold_2=0.5, block_vec_size=4, vector_layout=layout),
        mtx)
    # the CLI's solve-mode x (DefaultValues.x): the per-element flags
    # would trip on near-cancelling rows of a random x in sp
    x0 = init_x_host(op.config, op.n_rows, op.matrix_stats)
    assert x0.shape == (op.n_rows, 4)
    _, y = op.solve(op.make_x(x0), 5)
    for v in range(4):
        rep = validate_solve(mtx, x0[:, v], op.to_host(y)[:, v], 5,
                             value_type=value_type,
                             hp_nnz_fraction=op.hp_nnz_fraction())
        assert rep.flag == "OK", rep.summary()


def test_spmmv_bench_and_cli(tmp_path, capsys):
    op = SpmvOperator.from_mtx(
        config(Config, value_type="sp", block_vec_size=4,
               vector_layout="rowwise"), tgen.laplace3d(10))
    res = bench_spmv(op, bench_time=1e-3, warmup=1, start_iters=2,
                     timing_reps=2)
    assert res.block_vec_size == 4 and np.isfinite(res.perf_gflops)
    assert res.perf_gflops > 0 and res.effective_gbps > 0
    rc = cli.main(["Laplace3D,10", "scs", "-c", "1024", "-s", "1", "-sp",
                   "-block_vec_size", "4", "-layout", "rowwise", "-mode", "b",
                   "-bench_time", "0.001", "-backend", "cpu", "-json",
                   "-mtx_out", str(tmp_path)])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["block_vec_size"] == 4 and np.isfinite(rec["perf_gflops"])
    assert rec["perf_gflops"] > 0


# ------------------------------------------------- the plain version's forms


def port_dev(value_dtype):
    """A C=32, sigma=8 SCS of random_banded(700, 25, 9) built by the JAX
    package, on the CPU with ``value_dtype`` values; the host values are
    rounded to that dtype too, so ``spmv_reference`` sees the same matrix."""
    m = jgen.random_banded(700, 25, 9, seed=4)
    scs = j_convert(m.astype(np.float64), 32, 8, native=False)
    perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    perm[: scs.n_rows] = scs.old_to_new_idx
    j_permute(scs, perm)
    scs = scs_from_reference(dataclasses.asdict(scs))
    scs.values = torch.from_numpy(scs.values).to(value_dtype).double().numpy()
    return build_device_scs(scs, torch.device("cpu"), value_dtype), scs


PAIRS = [(v, x) for v, x in scs_spmv._ENTRY_POINTS]


@pytest.mark.parametrize("bs", [1, 3, 8, 11])
@pytest.mark.parametrize("layout", ["rowwise", "colwise"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_plain_layouts_match_spmv_reference(pair, layout, bs):
    vdt, xdt = pair
    dev, scs = port_dev(vdt)
    n = dev.n_rows_padded
    xs = np.random.default_rng(bs).standard_normal((n, bs))
    xs = torch.from_numpy(xs).to(xdt).numpy()  # rounded like x itself
    x = torch.from_numpy(xs if layout == "rowwise"
                         else np.ascontiguousarray(xs.T))
    y = spmv_scs(dev, x, layout)
    assert y.dtype == xdt and y.shape == x.shape
    ref = scs.spmv_reference(xs)  # f64 [n, bs]
    got = y.numpy() if layout == "rowwise" else y.numpy().T
    tol = 1e-12 if xdt == torch.float64 else 1e-5
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    # one block equals its columns one at a time
    for v in range(bs):
        col = x[:, v] if layout == "rowwise" else x[v]
        yv = spmv_scs(dev, col.contiguous())
        assert torch.equal(yv, y[:, v] if layout == "rowwise" else y[v])


@pytest.mark.parametrize("layout", ["rowwise", "colwise"])
def test_accumulate_form_adds_in_order(layout):
    dev_hi, _ = port_dev(torch.float64)
    dev_lo, _ = port_dev(torch.float32)
    n = dev_hi.n_rows_padded
    shape = (n, 4) if layout == "rowwise" else (4, n)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape))
    y0 = spmv_scs(dev_hi, x, layout)
    y1 = spmv_scs(dev_lo, x, layout)
    y = spmv_scs(dev_hi, x, layout)
    out = spmv_scs(dev_lo, x, layout, y)
    assert out is y and torch.equal(y, y0 + y1)
    with pytest.raises(ValueError, match="accumulate"):
        spmv_scs(dev_lo, x, layout, y.float())
    with pytest.raises(ValueError, match="accumulate"):
        spmv_scs(dev_lo, x, layout, y[:1])


def test_wrapper_rejects_unsupported_pairs_and_layouts():
    dev64, _ = port_dev(torch.float64)
    with pytest.raises(TypeError, match="no SCS kernel"):
        spmv_scs(dev64, torch.zeros(dev64.n_rows_padded))  # f64 A, f32 x
    dev, _ = port_dev(torch.float32)
    with pytest.raises(TypeError, match="no SCS kernel"):
        spmv_scs(dev, torch.zeros(dev.n_rows_padded, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="layout"):
        spmv_scs(dev, torch.zeros(dev.n_rows_padded, 2), "diagonal")
    with pytest.raises(ValueError, match="rows"):
        spmv_scs(dev, torch.zeros(dev.n_rows_padded, 2), "colwise")


@pytest.mark.parametrize("layout", ["rowwise", "colwise"])
@pytest.mark.parametrize("bs", [4, 16])
def test_sharded_bytes_read_sell_parts_per_pass_and_packed_once(bs, layout):
    """The sharded operator's byte count: its SELL-C-sigma parts once per
    pass of 8 vectors, its packed parts once, in either layout (a Laplacian
    at C=32 in 4 shards: packed halo parts beside SELL interiors)."""
    from uspmv_tpu_torch.ops.device_format import DevicePacked
    from uspmv_tpu_torch.parallel.distributed import DistributedSpmvOperator

    op = DistributedSpmvOperator.from_mtx(Config(
        backend="cpu", kernel_format="scs", chunk_size=32, sigma=1,
        value_type="sp", n_shards=4, seg_method="seg-nnz",
        split_rows_threshold=-1, block_vec_size=bs, vector_layout=layout),
        tgen.laplace2d(16))
    devs = op._devs("sp")
    packed = [d for d in devs if isinstance(d, DevicePacked)]
    assert packed and len(packed) < len(devs)
    want = sum((1 if isinstance(d, DevicePacked) else vector_pass_count(bs))
               * d.stream_bytes() for d in devs)
    assert op.bytes_per_spmv() == want + 4 * op.n_rows_padded * bs * 4 * 2
