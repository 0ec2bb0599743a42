"""ScaMaC's Hubbard chain: spin-1/2 fermions on a chain of n_sites sites,
n_fermions of each spin.

ScaMaC, the ESSEX-II project's scalable matrix collection
(https://bitbucket.org/essex/scamac), generates it as ``Hubbard``;
Ultimate-SpMV reads it through its bridge (utilities.hpp:1585-1752), with
the documented spec ``Hubbard,n_sites=10,n_fermions=5,U=1.3``
(utilities.hpp:1610). Here from its definition, in plain numpy:

    H = -t sum_{<i j>, s} (c+_{i s} c_{j s} + h.c.) + U sum_i n_{i up} n_{i dn}

over the product basis |up> (x) |dn>: the states of one species are the
n_sites-bit integers with n_fermions bits set (bit i: site i occupied), in
ascending order, D = C(n_sites, n_fermions) of them, and row i_up * D +
i_dn holds the pair. The bonds <i j> are (i, i + 1), and with ``pbc`` also
(0, n_sites - 1). A hop moves one fermion of one species across a bond to
an empty site; with the sites ordered by index (Jordan-Wigner), its sign
is -1 to the number of that species' fermions strictly between the two
sites: +1 on a nearest-neighbour bond, and on the wrap bond the parity of
the n_sites - 2 sites between. The interaction is diagonal, and the
diagonal is stored in every row, also where it is 0 (no site holds both
spins). Rows ascend, and columns ascend within a row.

nnz = D^2 + 2 D H1, H1 the hops of one species: each bond, in each
direction, takes the states with the one site occupied and the other
empty, C(n_sites - 2, n_fermions - 1) of them.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

BLOCK_NNZ = 1 << 24  # nonzeros built at a time, one block of up states


def _bonds(params: dict) -> list:
    L = int(params["n_sites"])
    bonds = [(i, i + 1) for i in range(L - 1)]
    if int(params.get("pbc", 0)) and L > 2:
        bonds.append((0, L - 1))
    return bonds


def nnz(params: dict) -> int:
    """The Hamiltonian's stored entries, in closed form."""
    L, n = int(params["n_sites"]), int(params["n_fermions"])
    D = math.comb(L, n)
    hops = 2 * len(_bonds(params)) * (math.comb(L - 2, n - 1)
                                      if L >= 2 and n >= 1 else 0)
    return D * D + 2 * D * hops


def _bits(a: np.ndarray, L: int) -> np.ndarray:
    """The set bits of each of ``a`` (each below 2^L)."""
    out = np.zeros(a.shape, dtype=np.int64)
    for i in range(L):
        out += (a >> i) & 1
    return out


def _species(params: dict):
    """One species' states, ascending, and its hops as CSR over the state
    index with targets ascending in each row: (states, ptr, target,
    amplitude)."""
    L, n, t = int(params["n_sites"]), int(params["n_fermions"]), \
        float(params["t"])
    states = np.array(sorted(sum(1 << i for i in c)
                             for c in itertools.combinations(range(L), n)),
                      dtype=np.int64)
    index = np.full(1 << L, -1, dtype=np.int64)
    index[states] = np.arange(states.size)
    src, dst, amp = [], [], []
    for a, b in _bonds(params):
        # one of a, b occupied: the fermion moves to the other
        movable = np.flatnonzero(((states >> a) ^ (states >> b)) & 1)
        between = (1 << b) - (1 << (a + 1))
        odd = _bits(states[movable] & between, L) & 1
        src.append(movable)
        dst.append(index[states[movable] ^ ((1 << a) | (1 << b))])
        amp.append(np.where(odd == 1, t, -t))
    src, dst, amp = (np.concatenate(v) if v else np.zeros(0, dtype=dt)
                     for v, dt in ((src, np.int64), (dst, np.int64),
                                   (amp, np.float64)))
    order = np.lexsort((dst, src))
    ptr = np.zeros(states.size + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=states.size), out=ptr[1:])
    return states, ptr, dst[order], amp[order]


def generate(params: dict) -> tuple:
    """(n_rows, n_cols, I, J, V): int32 rows ascending, int32 columns
    ascending within a row, float64 values."""
    L, U = int(params["n_sites"]), float(params["U"])
    states, ptr, tgt, amp = _species(params)
    D = states.size
    n, total = D * D, nnz(params)
    if max(n, total) >= 2**31:
        raise ValueError(f"hubbard: {n} rows, {total} nonzeros exceed "
                         "int32 indices")
    cnt = np.diff(ptr)
    src = np.repeat(np.arange(D), cnt)
    rank = np.arange(tgt.size) - ptr[src]  # place among its state's hops
    above = tgt > src
    below = cnt - np.bincount(src, weights=above, minlength=D).astype(
        np.int64)  # hops of each state to a lower state
    # each state's own block of a row: its hops and its diagonal, columns
    # ascending (the diagonal after the hops below it)
    in_block = np.zeros(D + 1, dtype=np.int64)
    np.cumsum(1 + cnt, out=in_block[1:])
    hop_slot = in_block[src] + rank + above
    diag_slot = in_block[:-1] + below
    block_col = np.empty(D + tgt.size, dtype=np.int64)
    block_col[hop_slot] = tgt
    block_col[diag_slot] = np.arange(D)
    block_amp = np.zeros(D + tgt.size)
    block_amp[hop_slot] = amp
    block_row = np.repeat(np.arange(D), 1 + cnt)
    per_up = D * (1 + cnt) + tgt.size  # nonzeros of each up state's rows
    first = np.zeros(D + 1, dtype=np.int64)
    np.cumsum(per_up, out=first[1:])

    pop = _bits(np.arange(1 << L, dtype=np.int64), L)  # doubly occupied
    I = np.empty(total, dtype=np.int32)
    J = np.empty(total, dtype=np.int32)
    V = np.empty(total, dtype=np.float64)
    k = np.arange(D, dtype=np.int64)
    u0 = 0
    while u0 < D:
        u1 = min(D, max(u0 + 1, int(np.searchsorted(
            first, first[u0] + BLOCK_NNZ, side="right")) - 1))
        part = slice(int(first[u0]), int(first[u1]))
        Ib, Jb, Vb = I[part], J[part], V[part]
        lens = 1 + cnt[u0:u1, None] + cnt[None, :]
        start = np.zeros(lens.size, dtype=np.int64)
        np.cumsum(lens.ravel()[:-1], out=start[1:])
        start = start.reshape(lens.shape)
        Ib[:] = np.repeat(np.arange(u0 * D, u1 * D, dtype=np.int32),
                          lens.ravel())
        # the up spin hops: below the row's own block, or past it
        h = slice(int(ptr[u0]), int(ptr[u1]))
        at = start[src[h] - u0] + rank[h][:, None] \
            + np.where(above[h], 1, 0)[:, None] * (1 + cnt[None, :])
        Jb[at] = tgt[h][:, None] * D + k[None, :]
        Vb[at] = amp[h][:, None]
        # the row's own block: the down spin hops and the diagonal
        at = start[:, block_row] + below[u0:u1, None] \
            + (np.arange(block_col.size) - in_block[block_row])[None, :]
        Jb[at] = np.arange(u0, u1, dtype=np.int64)[:, None] * D \
            + block_col[None, :]
        Vb[at] = block_amp[None, :]
        at = start + below[u0:u1, None] + below[None, :]
        Vb[at] = U * pop[states[u0:u1, None] & states[None, :]].astype(
            np.float64)
        u0 = u1
    return n, n, I, J, V
