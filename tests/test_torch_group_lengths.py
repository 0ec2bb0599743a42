"""The group lengths of the SELL-C-sigma row loop against the JAX package.

The kernel's row loop (uspmv_tpu_torch/csrc/scs_row.cuh) stops each group
of GROUP_ROWS consecutive permuted rows of a chunk at the longest of them,
where it stopped at the chunk's longest row. On the CPU: the group lengths
and byte counts of ``build_device_scs`` against a numpy maximum over the JAX
package's ``ScsData.row_counts_new``; the slots the loop no longer reads
are padding; a numpy walk of the loop in trips of K by group length visits
the slots of the walk by chunk length in the same order, less padding, and
sums to the same bits; and the plain version, which still adds 0 * x[0]
for every padding slot, against the JAX lane-tile and df64 kernels in
interpret mode on padded matrices. The kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import ml_dtypes

from uspmv_tpu.formats.scs import convert_to_scs as j_convert
from uspmv_tpu.formats.scs import permute_scs_cols as j_permute
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.io import scamac as jscamac
from uspmv_tpu.ops.pallas_scs import build_device_lane_tiles, spmv_lane_tiles
from uspmv_tpu.runtime.validate import UNIT_TOL

from uspmv_tpu_torch.formats.scs import convert_to_scs as t_convert
from uspmv_tpu_torch.formats.scs import scs_from_reference
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.io import scamac as tscamac
from uspmv_tpu_torch.ops import _build, scs_probe, scs_solve, scs_spmv
from uspmv_tpu_torch.ops.device_format import (
    GROUP_ROWS,
    GROUP_SKIP_PER_ROW,
    build_device_scs,
    group_table,
    length_dtype,
)
from uspmv_tpu_torch.ops.scs_spmv import spmv_scs, spmv_scs_plain

CPU = torch.device("cpu")

# small matrices with padding at every C: rows of 11 to 306 elements
# (RandomImbalanced's longest row needs int16 lengths), rows whole (no
# split)
MATRICES = {
    "WideSpectrum,4": lambda gen, scamac: gen.wide_spectrum(4),
    "FemTet3D,4": lambda gen, scamac: gen.fem_tet3d(4),
    "Hubbard,6,3": lambda gen, scamac: scamac.hubbard(n_sites=6,
                                                      n_fermions=3),
    "RandomImbalanced,600,6": lambda gen, scamac: gen.random_imbalanced(600,
                                                                        6),
}
FORMATS = sorted({(C, sigma) for C in (1, 4, 32, 1024)
                  for sigma in (1, 8, C)})
CASES = [(name, C, sigma) for name in sorted(MATRICES)
         for C, sigma in FORMATS]
HOST_DTYPES = {"f64": np.float64, "f32": np.float32,
               "bf16": ml_dtypes.bfloat16}


@functools.lru_cache(maxsize=None)
def jax_scs(name, C, sigma, dtype="f64", permuted=False):
    """The JAX package's SCS (numpy path), with the operator's symmetric
    column permutation where ``permuted``."""
    mtx = MATRICES[name](jgen, jscamac).astype(HOST_DTYPES[dtype])
    scs = j_convert(mtx, C, sigma, native=False)
    if permuted:
        perm = np.arange(scs.n_rows_padded, dtype=np.int32)
        perm[: scs.n_rows] = scs.old_to_new_idx
        j_permute(scs, perm)
    return scs


@functools.lru_cache(maxsize=None)
def port_scs(name, C, sigma):
    return t_convert(MATRICES[name](tgen, tscamac), C, sigma, native=False)


def numpy_group_lengths(counts, C, G=GROUP_ROWS):
    """Per group of G rows within each chunk of C, in order: the longest
    row (a chunk's last group holds what is left of it)."""
    out = []
    for c0 in range(0, counts.size, C):
        for g0 in range(c0, c0 + C, G):
            out.append(int(counts[g0:min(g0 + G, c0 + C)].max()))
    return np.asarray(out, dtype=np.int64)


def row_group_lengths(counts, C, G=GROUP_ROWS):
    """The length of each permuted row's group."""
    rows = np.arange(counts.size)
    chunk, i = rows // C, rows % C
    group = chunk * -(-C // G) + i // G
    return numpy_group_lengths(counts, C, G)[group]


def slots_read(counts, C, G=GROUP_ROWS):
    return int(row_group_lengths(counts, C, G).sum())


def by_groups(js):
    """Whether the stream takes group lengths: GROUP_ROWS divides C and
    they skip at least GROUP_SKIP_PER_ROW slots per padded row (else the
    kernel stops at each chunk's length)."""
    skipped = js.n_elements - slots_read(js.row_counts_new, js.C)
    return (js.C % GROUP_ROWS == 0
            and skipped >= GROUP_SKIP_PER_ROW * js.n_rows_padded)


@pytest.mark.parametrize("name,C,sigma", CASES)
def test_group_lengths_equal_the_jax_row_counts(name, C, sigma):
    js, ts = jax_scs(name, C, sigma), port_scs(name, C, sigma)
    assert np.array_equal(ts.row_counts_new, js.row_counts_new)
    dev = build_device_scs(ts, CPU)
    want = numpy_group_lengths(js.row_counts_new, C)
    # the kernel's table: a group's entry at r / GROUP_ROWS; none where
    # GROUP_ROWS does not divide C (C < GROUP_ROWS: a group is its chunk)
    # or the groups skip too little
    table = dev.group_lengths.numpy().astype(np.int64)
    if not by_groups(js):
        assert table.size == 0 and dev.group_length_bytes == 0
        assert dev.n_read == js.n_elements
    else:
        assert np.array_equal(table, want)
        longest = int(js.chunk_lengths.max())
        assert dev.group_lengths.dtype == (torch.uint8 if longest <= 255
                                           else torch.int16)
        assert dev.group_length_bytes == dev.group_lengths.element_size()
    # a group is never longer than its chunk; C = 1: the row counts
    per_chunk = want.reshape(ts.n_chunks, -1)
    assert np.all(per_chunk.max(axis=1) == js.chunk_lengths)
    if C == 1:
        assert np.array_equal(want, js.row_counts_new)


@pytest.mark.parametrize("name,C,sigma", CASES)
def test_slots_past_a_group_length_are_padding(name, C, sigma):
    """Every slot at or past its group's length holds value 0 and column 0
    (before the column permutation), in the host arrays and on the
    device; some such slot exists wherever a group is shorter than its
    chunk."""
    js, ts = jax_scs(name, C, sigma), port_scs(name, C, sigma)
    dev = build_device_scs(ts, CPU)
    per_chunk = js.chunk_lengths.astype(np.int64) * C
    start = np.repeat(js.chunk_ptrs[:-1].astype(np.int64), per_chunk)
    j = (np.arange(js.n_elements) - start) // C
    rows = js.flat_row_idx()
    unread = j >= row_group_lengths(js.row_counts_new, C)[rows]
    assert np.all(js.values[unread] == 0) and np.all(js.col_idxs[unread] == 0)
    assert np.all(dev.values.numpy()[unread] == 0)
    assert np.all(dev.col_idxs.numpy()[unread] == 0)
    assert int(unread.sum()) == js.n_elements - slots_read(
        js.row_counts_new, C)
    assert dev.n_read == js.n_elements - (int(unread.sum()) if by_groups(js)
                                          else 0)


def walk(scs, bound, K, x):
    """The row loop in numpy, every row at once: ``for j0 in range(0,
    bound[r], K)``, then ``k < K`` with ``j0 + k < bound[r]``, slot e =
    chunk_ptrs[c] + j*C + i, acc = acc + value * x[col] in float32 from
    +0. Returns (slots visited per row in order, as [n_rows_padded, steps]
    with -1 where none, the sums, the trips per row)."""
    n, C = scs.n_rows_padded, scs.C
    rows = np.arange(n)
    base = scs.chunk_ptrs[rows // C].astype(np.int64) + rows % C
    top = -(-int(bound.max(initial=0)) // K) * K
    visited = np.full((n, top), -1, dtype=np.int64)
    acc = np.zeros(n, dtype=np.float32)
    trips = np.zeros(n, dtype=np.int64)
    vals = scs.values.astype(np.float32)
    for j0 in range(0, top, K):
        trips += j0 < bound
        for k in range(K):
            on = j0 + k < bound
            e = base[on] + (j0 + k) * C
            visited[on, j0 + k] = e
            acc[on] = acc[on] + vals[e] * x[scs.col_idxs[e]]
    return visited, acc, trips


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("name,C,sigma", CASES)
def test_group_walk_is_the_chunk_walk_without_padding(name, C, sigma, K):
    """Trips of K = kBatchX / BS elements (4, 2, 1): the walk by group
    length takes the chunk walk's slots in its order and leaves out only
    padding, so its sums are bit-equal for a finite x."""
    js = jax_scs(name, C, sigma, "f32", permuted=True)
    rows = np.arange(js.n_rows_padded)
    by_chunk = js.chunk_lengths.astype(np.int64)[rows // C]
    by_group = row_group_lengths(js.row_counts_new, C)
    x = np.random.default_rng(C + sigma).standard_normal(
        js.n_rows_padded).astype(np.float32)
    v_g, acc_g, trips_g = walk(js, by_group, K, x)
    v_c, acc_c, trips_c = walk(js, by_chunk, K, x)
    width = v_g.shape[1]
    assert np.array_equal(v_g, np.where(np.arange(width) < by_group[:, None],
                                        v_c[:, :width], -1))
    skipped = np.setdiff1d(v_c[v_c >= 0], v_g[v_g >= 0])
    assert skipped.size == js.n_elements - slots_read(js.row_counts_new, C)
    assert np.all(js.values[skipped] == 0)
    assert np.array_equal(acc_g.view(np.uint32), acc_c.view(np.uint32))
    assert np.array_equal(trips_g, -(-by_group // K))
    assert np.all(trips_g <= trips_c)


@pytest.mark.parametrize("name,C,sigma", CASES)
def test_stream_bytes_count_the_slots_read(name, C, sigma):
    """Per slot below its group's length a value (8, 4 or 2 B) and an int32
    column; chunk_ptrs; the table of lengths, one per group, in the
    narrowest integer. The unit stream's loop still walks every slot."""
    js, ts = jax_scs(name, C, sigma), port_scs(name, C, sigma)
    read = slots_read(js.row_counts_new, C)
    n_lengths = ts.n_rows_padded // GROUP_ROWS
    width = 1 if int(js.chunk_lengths.max()) <= 255 else 2
    for dtype, size in ((None, 8), (torch.float32, 4), (torch.bfloat16, 2)):
        dev = build_device_scs(ts, CPU, dtype)
        chunks = ts.n_elements * (size + 4) + 4 * (2 * ts.n_chunks + 1)
        assert dev.chunk_stream_bytes() == chunks
        if not by_groups(js):  # every slot, and each chunk's length
            assert dev.n_read == ts.n_elements
            assert dev.stream_bytes() == chunks
            assert dev.device_beta == js.beta
            continue
        assert dev.n_read == read < ts.n_elements
        assert dev.stream_bytes() == read * (size + 4) + 4 * (
            ts.n_chunks + 1) + width * n_lengths
        assert dev.device_beta == js.nnz / read >= js.beta
    ones = dataclasses.replace(ts, values=(ts.values != 0).astype(np.float32))
    unit = build_device_scs(ones, CPU, unit_values=True)
    assert unit.n_read == ts.n_elements
    assert unit.stream_bytes() == 4 * ts.n_elements + 4 * (2 * ts.n_chunks
                                                          + 1)


@pytest.mark.parametrize("C", [32, 1024])
def test_streams_that_skip_little_keep_the_chunk_lengths(C):
    """Laplace3D-12's groups of 16 rows skip 0.02 slots per padded row at
    C=32, under GROUP_SKIP_PER_ROW: no table, every slot read, the chunk
    walk's bytes. At C=1024 its last chunk's empty rows make the groups
    skip 1.3 slots per row: a table of one byte per 16 rows."""
    mtx = tgen.laplace3d(12)
    ts = t_convert(mtx, C, 1, native=False)
    per_row = (ts.n_elements - slots_read(ts.row_counts_new, C)
               ) / ts.n_rows_padded
    dev = build_device_scs(ts, CPU)
    if C == 32:
        assert 0 < per_row < GROUP_SKIP_PER_ROW
        assert dev.group_length_bytes == 0 and dev.n_read == ts.n_elements
        assert dev.stream_bytes() == dev.chunk_stream_bytes()
        assert len(scs_spmv.matrix_args(dev)) == 8
        assert scs_spmv.matrix_args(dev)[5] == 0
        # the table all the same at skip_per_row 0 (scripts/kernel_ab.py times
        # such streams by group lengths)
        table, read = group_table(ts, skip_per_row=0)
        assert table.size == ts.n_rows_padded // GROUP_ROWS
        assert read == slots_read(ts.row_counts_new, C) < ts.n_elements
    else:
        assert per_row >= GROUP_SKIP_PER_ROW
        assert dev.group_length_bytes == 1
        assert dev.group_lengths.numel() == ts.n_rows_padded // GROUP_ROWS


def test_length_dtype_is_the_narrowest():
    assert [length_dtype(n) for n in (0, 255, 256, 32767, 32768, 2**31 - 1)
            ] == [np.uint8, np.uint8, np.int16, np.int16, np.int32, np.int32]


def test_build_needs_the_row_counts():
    ts = dataclasses.replace(port_scs("FemTet3D,4", 32, 1),
                             row_counts_new=None)
    with pytest.raises(ValueError, match="row_counts_new"):
        build_device_scs(ts, CPU)


def c_params(source, name):
    """The parameter count of extern "C" function ``name`` in a csrc file."""
    text = (_build.CSRC_DIR / source).read_text()
    body = text.split('extern "C" {', 1)[1]
    m = re.search(rf"\bint {name}\(([^)]*)\)\s*\{{", body)
    assert m, f"{name} not defined in {source}"
    return len(m.group(1).split(","))


def test_the_bound_argument_lists_match_the_sources():
    """GROUP_ROWS is the kernel's kGroupRows, and every entry point of the
    row loop takes as many arguments as its wrapper binds (the kernels
    are compiled on the card only)."""
    row = (_build.CSRC_DIR / "scs_row.cuh").read_text()
    assert f"constexpr int kGroupRows = {GROUP_ROWS};" in row
    for name in [*scs_spmv._ENTRY_POINTS.values(), scs_spmv.UNIT_ENTRY]:
        assert c_params("scs_spmv.cu", name) == len(scs_spmv._ARGTYPES)
    for name in scs_solve._ENTRY_POINTS.values():
        assert c_params("scs_solve.cu", name) == len(scs_solve._ARGTYPES)
    assert c_params("scs_probe.cu", scs_probe._ENTRY) == len(
        scs_probe._ARGTYPES)
    assert len(scs_spmv.matrix_args(build_device_scs(
        port_scs("FemTet3D,4", 32, 1), CPU))) == 8


# ---------------------------------------- the plain version vs JAX kernels

def port_dev(js, value_dtype):
    """The very same arrays as the port's DeviceScs, values in
    ``value_dtype`` (bf16 held as float32 on the host)."""
    fields = dataclasses.asdict(js)
    if value_dtype == torch.bfloat16:
        fields["values"] = js.values.astype(np.float32)
    return build_device_scs(scs_from_reference(fields), CPU, value_dtype)


def jax_product(js, kernel, x64):
    """The JAX kernel in interpret mode on x (f64 [n] or [n, bs]): the
    lane tiles in f32 or bf16 on x rounded to f32 (the JAX operator's sp
    and hp partials under -dp_emu take the hi part), or the df64 kernel
    on the (hi, lo) pair."""
    bs = 1 if x64.ndim == 1 else x64.shape[1]
    if kernel == "df64":
        hi = x64.astype(np.float32)
        lo = (x64 - hi.astype(np.float64)).astype(np.float32)
        dev = build_device_lane_tiles(js, dtype=np.float64, block_vec_size=bs)
        assert dev.df64
        pair = np.asarray(spmv_lane_tiles(
            dev, jnp.asarray(np.stack([hi, lo], -1)), interpret=True))
        return pair[..., 0].astype(np.float64) + pair[..., 1]
    dtype = ml_dtypes.bfloat16 if kernel == "bf16" else np.float32
    dev = build_device_lane_tiles(js, dtype=dtype, block_vec_size=bs)
    return np.asarray(spmv_lane_tiles(dev, jnp.asarray(
        x64.astype(np.float32)), interpret=True)).astype(np.float64)


# JAX kernel -> (host values it reads, the port's (values, x) pairs that
# answer it)
KERNELS = {
    "f32": ("f32", [(torch.float32, torch.float32),
                    (torch.float32, torch.float64)]),
    "bf16": ("bf16", [(torch.bfloat16, torch.float32),
                      (torch.bfloat16, torch.float64)]),
    "df64": ("f64", [(torch.float64, torch.float64)]),
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plain_matches_jax_kernels_on_padded_streams(name, kernel):
    """C=1024, sigma=1 (lane tiles need C = 1024): every (values, x) pair,
    rowwise bs 1, 4, 8 and colwise bs 4, 8 (the JAX operator runs a
    colwise block one vector at a time through the same kernel), at
    validate.UNIT_TOL["sp"]: the JAX kernels sum in f32 here (the df64
    pair is float-accurate in interpret mode, off the chip)."""
    host, pairs = KERNELS[kernel]
    js = jax_scs(name, 1024, 1, host, permuted=True)
    read = slots_read(js.row_counts_new, 1024)
    assert js.nnz < read < js.n_elements  # padding below and past groups
    real = js.old_to_new_idx
    rng = np.random.default_rng(len(name))
    for bs in (1, 4, 8):
        x = rng.standard_normal((js.n_rows_padded, bs))
        x[np.setdiff1d(np.arange(js.n_rows_padded), real)] = 0
        x = x[:, 0] if bs == 1 else x
        want = jax_product(js, kernel, x)[real]
        scale = np.abs(want).max()
        for vdt, xdt in pairs:
            dev = port_dev(js, vdt)
            layouts = ["rowwise"] if bs == 1 else ["rowwise", "colwise"]
            for layout in layouts:
                xt = torch.from_numpy(x).to(xdt)
                if layout == "colwise":
                    xt = xt.T.contiguous()
                y = spmv_scs(dev, xt, layout).double().numpy()
                assert np.array_equal(
                    y, spmv_scs_plain(dev, xt, layout).double().numpy())
                y = y.T if layout == "colwise" else y
                err = np.abs(y[real] - want).max() / scale
                assert err <= UNIT_TOL["sp"], (vdt, xdt, layout, bs, err)
