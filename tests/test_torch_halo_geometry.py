"""The launch geometry of the halo kernels (``ops/halo_exchange.
launch_geometry``) against the choices of csrc/halo_exchange.cu, on the CPU.

A launch copies n pairs: thread t of the grid's ``grid`` x ``threads``
threads takes pair t and, in the turns of a grid-stride loop, t + grid *
threads, ..., for each of ``n_vec`` colwise vectors. Walking that loop must
visit every pair exactly once; rows move in 16-byte units only where the
row's bytes, its stride and the vectors' stride are multiples of 16 and the
buffers are aligned; the grid never exceeds one wave of the card (SMs x
resident blocks). The card itself answers the same query in
tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu_torch.ops import halo_exchange as hx

SOURCE = (Path(__file__).resolve().parents[1] / "uspmv_tpu_torch" / "csrc"
          / "halo_exchange.cu")
# (SMs, resident blocks per SM): an H100 SXM at 8 blocks of 256 threads,
# and a card so small that the wave caps every grid below
CARDS = [(132, 8), (4, 2)]
LAYOUTS = [("rowwise", 1), ("rowwise", 3), ("rowwise", 4), ("rowwise", 8),
           ("colwise", 8)]
ROWS = 1_000_003  # rows of the stacked buffer: its colwise vector stride


def strides(layout, bs):
    """(n_vec, ld, ncols, vstride) of the wrapper for a stacked buffer."""
    if layout == "colwise":
        return bs, 1, 1, ROWS
    return 1, bs, bs, 0


def visits(geo, n):
    """How often the kernel's grid-stride loop visits each of n pairs."""
    total = geo["grid"] * geo["threads"]
    turns = -(-n // total)
    pairs = (np.arange(total)[None, :]
             + total * np.arange(turns)[:, None]).ravel()
    return np.bincount(pairs[pairs < n], minlength=n)


@pytest.mark.parametrize("card", CARDS, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("layout,bs", LAYOUTS)
@pytest.mark.parametrize("n", [1, 3, 4, 5, 98_304])
def test_launch_covers_every_pair_once_within_one_wave(n, layout, bs,
                                                       itemsize, card):
    n_sm, per_sm = card
    n_vec, ld, ncols, vstride = strides(layout, bs)
    geo = hx.launch_geometry(n, n_vec, ld, ncols, itemsize, n_sm, per_sm,
                             vstride)
    assert geo["threads"] == hx.THREADS
    assert geo["n_vec"] == n_vec
    assert (visits(geo, n) == 1).all()
    # never more than one wave, and no block without a pair
    assert geo["grid"] * n_vec <= n_sm * per_sm
    assert (geo["grid"] - 1) * geo["threads"] < n
    # 16 B units for rows of a multiple of 16 bytes in the rowwise layout:
    # bs 4 f32 (one unit), bs 8 f32 and bs 4 f64 (two), bs 8 f64 (four)
    row_bytes = ncols * itemsize
    wide = layout == "rowwise" and row_bytes % 16 == 0
    assert geo["unit_bytes"] == (16 if wide else itemsize)
    assert geo["unit_bytes"] * geo["row_units"] == row_bytes


@pytest.mark.parametrize("bs", [4, 8])
def test_unaligned_buffers_move_a_value_at_a_time(bs):
    for itemsize in (4, 8):
        geo = hx.launch_geometry(5, 1, bs, bs, itemsize, 132, 8,
                                 aligned=False)
        assert geo["unit_bytes"] == itemsize
        assert geo["row_units"] == bs
    # a row of 16 bytes whose stride is not a multiple of 16 bytes
    geo = hx.launch_geometry(5, 1, 5, 4, 4, 132, 8)
    assert (geo["unit_bytes"], geo["row_units"]) == (4, 4)
    # colwise vectors whose stride is not a multiple of 16 bytes
    geo = hx.launch_geometry(5, 2, 4, 4, 4, 132, 8, vstride=3)
    assert (geo["unit_bytes"], geo["row_units"]) == (4, 4)


def test_grid_stride_loop_beyond_one_wave():
    """4 M + 3 pairs on an H100: 1,056 blocks of 256 threads hold 270,336
    of them, so every thread takes 15 or 16 turns of the loop."""
    n = 4 * 2**20 + 3
    geo = hx.launch_geometry(n, 1, 1, 1, 4, 132, 8)
    assert geo["grid"] == 132 * 8
    hits = visits(geo, n)
    assert (hits == 1).all()


def test_geometry_refuses_an_empty_launch():
    with pytest.raises(ValueError, match="n >= 1"):
        hx.launch_geometry(0, 1, 1, 1, 4, 132, 8)


def test_constants_are_those_of_the_source():
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kThreads") == hx.THREADS
    assert const("kVectorBytes") == hx.VECTOR_BYTES
    # the old per-pair kernels are gone: one template serves all three
    assert "halo_copy_kernel" in text
    assert "halo_exchange_kernel" not in text
    assert "halo_buffer_kernel" not in text
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in text
