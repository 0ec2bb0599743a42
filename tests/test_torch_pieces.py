"""The work records of the heavy-row pieces kernel, on the CPU.

``build_device_pieces`` cuts the parents' runs of pieces into the records
that csrc/scs_pieces.cu walks: parents of at most ``RECORD_PIECES`` pieces
are packed, whole and consecutive, into records that a warp sums and folds
in registers; a longer parent is several records, each folded into one
sum in ``slots``, counted on an int32 counter per parent. The kernel runs
only on the card (tests/test_torch_cuda.py); here the records are checked
for what the kernel relies on, and a numpy walk of the records in the
kernel's order (lanes, butterflies, the 8-value tree of a short parent or
a long parent's record, slots, counters) is held bit for bit against the
order of a piece sum per warp followed by a fold per parent (that of the
two-pass design) on the short parents' rows, and within tolerance against
it and ``spmv_pieces_plain``, which the JAX comparisons of
tests/test_torch_split.py cover, on every row.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu_torch.formats.coo import split_heavy_rows
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.ops.device_format import (
    RECORD_PIECES,
    build_device_pieces,
    piece_records,
)
from uspmv_tpu_torch.ops.scs_pieces import spmv_pieces

CPU = torch.device("cpu")
CSRC = Path(__file__).resolve().parents[1] / "uspmv_tpu_torch" / "csrc"
WARP = 32

MATRICES = {
    "random_imbalanced(2000,8)": lambda: tgen.random_imbalanced(2000, 8),
    "banded_imbalanced(3000,64,8)": lambda: tgen.banded_imbalanced(
        3000, bandwidth=64, avg_nnz_per_row=8, seed=7),
}


def pieces_of(name, threshold, dtype=torch.float32, n_vec=1):
    """The pieces of a generated matrix split at ``threshold``, in the
    original row order (rows and columns unpermuted)."""
    m = MATRICES[name]()
    split, parent = split_heavy_rows(m, threshold)
    cut = int(np.searchsorted(split.I, m.n_rows))
    return build_device_pieces(
        split.I[cut:].astype(np.int64) - m.n_rows, split.J[cut:],
        split.values[cut:], parent, m.n_rows, CPU, dtype, n_vec=n_vec)


# random_imbalanced(2000, 8) split at 2 has parents of up to 251 pieces,
# at 8 up to 62, at 32 up to 16; banded_imbalanced at 32 up to 2
CASES = [(name, th) for name in MATRICES for th in (2, 8, 32)]


def case_id(case):
    return f"{case[0]}-th{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_records_cover_every_piece_once(case):
    pc = pieces_of(*case)
    rec = pc.records.numpy()
    assert pc.records.dtype == torch.int32 and rec.shape[1] == 4
    covered = np.zeros(pc.n_pieces, dtype=np.int64)
    for first, end, _, _ in rec:
        assert 0 < end - first <= RECORD_PIECES
        covered[first:end] += 1
    assert (covered == 1).all()
    # a long record lies within its parent; a short one holds its
    # parents whole
    ptr = pc.parent_ptr.numpy()
    for first, end, q0, kind in rec:
        if kind >= 0:
            assert ptr[q0] <= first < end <= ptr[q0 + 1]
        else:
            assert (first, end) == (ptr[q0], ptr[q0 - kind])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_short_and_long_parents_follow_the_rule(case):
    pc = pieces_of(*case)
    rec, longs = pc.records.numpy(), pc.longs.numpy()
    ptr = pc.parent_ptr.numpy()
    runs = np.diff(ptr)
    R = RECORD_PIECES
    is_long = rec[:, 3] >= 0
    assert is_long.sum() == (-(-runs[runs > R] // R)).sum()
    # long records first, then every short parent once, in order, packed
    # greedily: a record takes the next parent where it is short, next in
    # order and fits
    assert np.array_equal(is_long, np.sort(is_long)[::-1])
    short = rec[~is_long]
    parents = np.concatenate([np.arange(q0, q0 - kind)
                              for _, _, q0, kind in short] or [[]])
    assert np.array_equal(parents, np.flatnonzero(runs <= R))
    for (_, end, q0, kind), (_, _, q1, _) in zip(short[:-1], short[1:]):
        q = q0 - kind
        assert not (q == q1 and runs[q] + end - ptr[q0] <= R)
    # long parent l: its pieces, its records, its slots (one per record)
    # after l-1's, the largest parents first
    assert longs.shape == ((runs > R).sum(), 4)
    assert (longs[:, 2] > R).all() and (np.diff(longs[:, 2]) <= 0).all()
    assert np.array_equal(longs[:, 0], np.cumsum(longs[:, 3]) - longs[:, 3])
    for l, (_, first, n, n_rec) in enumerate(longs):
        mine = rec[rec[:, 3] == l]
        assert mine.shape[0] == n_rec == -(-n // R)
        assert mine[0, 0] == first and mine[-1, 1] == first + n
        assert (mine[:, 2] == mine[0, 2]).all() and ptr[mine[0, 2]] == first


@pytest.mark.parametrize("n_vec", [1, 4])
@pytest.mark.parametrize("dtype,acc", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float64, torch.float64)])
def test_counters_and_slots_start_at_zero(dtype, acc, n_vec):
    pc = pieces_of("random_imbalanced(2000,8)", 2, dtype, n_vec)
    n_long = pc.longs.shape[0]
    assert n_long > 0
    assert pc.arrivals.dtype == torch.int32
    assert pc.arrivals.shape == (n_vec, n_long) and not pc.arrivals.any()
    # a 64-bit word per 32 bits of the accumulator
    words = torch.finfo(acc).bits // 32
    assert pc.slots.dtype == torch.int64 and not pc.slots.any()
    assert pc.slots.shape == (n_vec, int(pc.longs[:, 3].sum()), words)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_stream_bytes_counts_what_the_records_move(case):
    pc = pieces_of(*case)
    rec, longs = pc.records.numpy(), pc.longs.numpy()
    # per record: its pieces' values and columns and their piece_ptr, its
    # parents' runs and rows, a long one's slot (one word for a float sum)
    # written, read and cleared; per long parent: its entry, its counter
    # read and written
    elems = sum(int(pc.piece_ptr[e] - pc.piece_ptr[f]) for f, e, _, _ in rec)
    assert elems == pc.nnz
    long_records = int((rec[:, 3] >= 0).sum())
    want = (elems * (4 + 4) + 4 * (pc.n_pieces + 1)
            + 4 * (2 * pc.n_parents + 1) + 16 * rec.shape[0]
            + 16 * longs.shape[0] + 8 * longs.shape[0] + 3 * 8 * long_records)
    assert pc.stream_bytes() == want


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bound_bytes_counts_the_function_alone(case):
    pc = pieces_of(*case)
    # the values and columns, piece_ptr and the parents' runs and rows:
    # none of the records, counters or slots the kernel chose to move
    want = (pc.nnz * (4 + 4) + 4 * (pc.n_pieces + 1)
            + 4 * (2 * pc.n_parents + 1))
    assert pc.bound_bytes() == want
    long_records = int((pc.records[:, 3] >= 0).sum())
    assert pc.stream_bytes() - pc.bound_bytes() == (
        16 * pc.records.shape[0] + 24 * pc.longs.shape[0]
        + 3 * 8 * long_records)


def greedy_short_records(q, ptr, cap):
    """The short parents' records one parent at a time: extend the open
    record with parent p where p follows its last parent and the record
    stays within ``cap`` pieces, else open a new one."""
    recs = []  # [first parent, parents]
    for p in q:
        if (recs and recs[-1][0] + recs[-1][1] == p
                and ptr[p + 1] - ptr[recs[-1][0]] <= cap):
            recs[-1][1] += 1
        else:
            recs.append([p, 1])
    return [[ptr[p], ptr[p + n], p, -n] for p, n in recs]


@pytest.mark.parametrize("seed", range(4))
def test_short_records_equal_the_greedy_walk(seed):
    rng = np.random.default_rng(seed)
    R = RECORD_PIECES
    runs = rng.integers(1, 2 * R + 2, int(rng.integers(1, 400)))
    ptr = np.concatenate(([0], np.cumsum(runs)))
    rec, _ = piece_records(ptr)
    short = rec[rec[:, 3] < 0].tolist()
    assert short == greedy_short_records(np.flatnonzero(runs <= R), ptr, R)


def test_piece_records_edge_cases():
    empty = piece_records(np.zeros(1, np.int64))
    assert [a.shape for a in empty] == [(0, 4), (0, 4)]
    R = RECORD_PIECES
    # parents of R, R + 1, 1, 2, R - 3 and 1 pieces
    ptr = np.cumsum([0, R, R + 1, 1, 2, R - 3, 1])
    rec, longs = piece_records(ptr)
    assert rec.tolist() == [[R, 2 * R, 1, 0], [2 * R, 2 * R + 1, 1, 0],
                            [0, R, 0, -1], [2 * R + 1, 3 * R + 1, 2, -3],
                            [3 * R + 1, 3 * R + 2, 5, -1]]
    assert longs.tolist() == [[0, R, R + 1, 2]]
    # two long parents: the larger first, slots after the first one's
    ptr = np.cumsum([0, 2 * R + 1, 1, 3 * R])
    rec, longs = piece_records(ptr)
    assert longs.tolist() == [[0, 2 * R + 2, 3 * R, 3], [3, 0, 2 * R + 1, 3]]
    assert rec[:, 3].tolist() == [0, 0, 0, 1, 1, 1, -1]
    assert rec[-1].tolist() == [2 * R + 1, 2 * R + 2, 1, -1]


def test_records_match_the_kernels_size():
    # the host cuts records for the kernel's kBatch pieces per warp
    pieces = (CSRC / "scs_pieces.cu").read_text()
    batch = int(re.search(r"constexpr int kBatch = (\d+);", pieces)[1])
    assert RECORD_PIECES == batch


# ------------------------------------------- the kernel's order, in numpy


def warp_sum(v):
    """The xor butterfly of csrc/scs_pieces.cu over 32 lanes; every lane
    ends with the same bits, lane 0's are returned."""
    lanes = np.arange(WARP)
    for offset in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ offset]
    assert (v == v[0]).all()
    return v[0]


def piece_sum(pc, p, x, dt):
    """Lane l sums elements l, l+32, ... of piece p in order, then the
    butterfly (an FMA per element on the card; here the product is rounded
    first, the same in both walks below)."""
    ptr = pc.piece_ptr.numpy()
    vals = pc.values.to(torch.float64).numpy().astype(dt)
    cols = pc.col_idxs.numpy()
    acc = np.zeros(WARP, dt)
    for k in range(ptr[p], ptr[p + 1]):
        acc[(k - ptr[p]) % WARP] += vals[k] * x[cols[k]]
    return warp_sum(acc)


def fold(sums, dt):
    """A parent's piece sums: the j-th to lane j mod 32, in order of j from
    0, then the butterfly."""
    acc = np.zeros(WARP, dt)
    for j, s in enumerate(sums):
        acc[j % WARP] += s
    return warp_sum(acc)


def two_pass(pc, x, y, dt):
    """A warp per piece writes its sum, a warp per parent folds its run."""
    partials = [piece_sum(pc, p, x, dt) for p in range(pc.n_pieces)]
    ptr, rows = pc.parent_ptr.numpy(), pc.parent_row.numpy()
    for q in range(pc.n_parents):
        y[rows[q]] += fold(partials[ptr[q]:ptr[q + 1]], dt)
    return y


def tree8(r):
    """The steps 4, 2, 1 of the butterfly over 8 values, as the kernel
    folds a short parent in one thread."""
    r = list(r)
    for d in (4, 2, 1):
        for j in range(d):
            r[j] = r[j] + r[j + d]
    return r[0]


def records_walk(pc, x, y, dt):
    """The kernel's walk of the records: a short record folds each of its
    parents in registers (0 + s_j for its j-th piece, then tree8); a long
    one folds its pieces so into its record's sum and writes it to the
    record's slot, and the record that brings the parent's counter to its
    record count folds the parent's slots and clears them and the
    counter."""
    slots = np.full(pc.slots.shape[1], np.nan, dt)
    arrivals = pc.arrivals[0].numpy().copy()
    longs = pc.longs.numpy()
    ptr, rows = pc.parent_ptr.numpy(), pc.parent_row.numpy()

    def fold8(sums):
        return tree8([dt(0) + s for s in sums] + [dt(0)] * (8 - len(sums)))

    for first, end, q0, kind in pc.records.numpy():
        sums = [piece_sum(pc, p, x, dt) for p in range(first, end)]
        if kind < 0:
            for q in range(q0, q0 - kind):
                y[rows[q]] += fold8(sums[ptr[q] - first:ptr[q + 1] - first])
            continue
        base, first_piece, _, n_rec = longs[kind]
        slot = base + (first - first_piece) // RECORD_PIECES
        assert np.isnan(slots[slot])
        slots[slot] = fold8(sums)
        arrivals[kind] += 1
        if arrivals[kind] == n_rec:
            y[rows[q0]] += fold(slots[base:base + n_rec], dt)
            arrivals[kind] = 0
    assert not arrivals.any() and not np.isnan(slots).any()
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("th", [2, 5])
def test_records_walk_keeps_the_short_parents_order(th, dtype):
    pc = pieces_of("random_imbalanced(2000,8)", th, dtype)
    assert pc.longs.shape[0] > 0 and (pc.records[:, 3] < 0).any()
    dt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(th)
    x = rng.standard_normal(pc.n_rows_padded).astype(dt)
    y0 = rng.standard_normal(pc.n_rows_padded).astype(dt)
    walked = records_walk(pc, x, y0.copy(), dt)
    two = two_pass(pc, x, y0.copy(), dt)
    runs = np.diff(pc.parent_ptr.numpy())
    # the short parents' rows and every row of no parent keep their bits
    keep = np.ones(walked.size, dtype=bool)
    keep[pc.parent_row.numpy()[runs > RECORD_PIECES]] = False
    assert np.array_equal(walked[keep], two[keep])
    plain = spmv_pieces(pc, torch.from_numpy(x), "rowwise",
                        torch.from_numpy(y0.copy())).numpy()
    tol = 1e-5 if dt == np.float32 else 1e-12
    for want in (two, plain):
        assert np.abs(walked - want).max() <= tol * np.abs(want).max()
