"""ScaMaC-style scalable matrix generators.

Port of ``uspmv_tpu/io/scamac.py``: the same models, option names,
defaults and guards, and matrices bit-equal to the JAX package's for the
same spec (the random parts draw from ``np.random.default_rng(seed)`` in
the same order).

The reference can generate inputs with the ScaMaC library instead of
reading .mtx files (scamac_generate, utilities.hpp:1585-1752: parses an
argument string like "Hubbard,n_sites=10", generates rows in parallel,
gathers a COO matrix). No external library here — representative quantum
models are generated natively in numpy with the same argument-string
interface:

  Anderson        3-D Anderson localization: -Laplacian + disorder diagonal
                  (params: Lx[,Ly,Lz], disorder, seed, pbc)
  Hubbard         1-D fermionic Hubbard chain in the fixed-filling sector
                  (params: n_sites, n_fermions, t, U, ranpot, seed, pbc) —
                  the reference's canonical ScaMaC example
                  ("Hubbard,n_sites=10,n_fermions=5,U=1.3",
                  utilities.hpp:1610)
  SpinChainXXZ    Heisenberg XXZ chain, dimension 2^L
                  (params: L, Jxy, Jz, Bz, seed — Bz>0 adds a random field)
  SpinChainXY     anisotropic XY chain, dimension 2^L (params: L, Jx, Jy,
                  Bz, pbc) — Jx != Jy breaks Sz conservation
  BoseHubbard     1-D Bose-Hubbard chain at fixed boson number
                  (params: n_sites, n_bosons, t, U, pbc)
  Tridiagonal     1-D chain (params: n, diag, off)

Specs parse as "Model,key=value,key=value" (case-insensitive model names,
matching ScaMaC's option syntax).
"""

from __future__ import annotations

import numpy as np

from ..formats.coo import MtxData


def _parse_spec(spec: str):
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError("empty ScaMaC spec")
    name = parts[0].lower()
    kwargs = {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"bad ScaMaC option {p!r} (expected key=value)")
        k, v = p.split("=", 1)
        try:
            kwargs[k.strip()] = int(v)
        except ValueError:
            try:
                kwargs[k.strip()] = float(v)
            except ValueError:
                kwargs[k.strip()] = v.strip()
    return name, kwargs


def anderson(Lx: int, Ly: int = 0, Lz: int = 0, disorder: float = 16.5,
             seed: int = 1, pbc: int = 0) -> MtxData:
    """3-D Anderson model: H = -sum_<ij> |i><j| + sum_i eps_i |i><i| with
    eps_i uniform in [-disorder/2, disorder/2]."""
    Ly = Ly or Lx
    Lz = Lz or Lx
    n = Lx * Ly * Lz
    rng = np.random.default_rng(seed)
    idx = np.arange(n).reshape(Lx, Ly, Lz)
    I, J, V = [idx.reshape(-1)], [idx.reshape(-1)], [
        rng.uniform(-disorder / 2, disorder / 2, n)
    ]
    for axis, L in ((0, Lx), (1, Ly), (2, Lz)):
        if L < 2:
            continue
        nbr = np.roll(idx, -1, axis=axis)
        src, dst = idx, nbr
        if not pbc:
            sl = [slice(None)] * 3
            sl[axis] = slice(0, L - 1)
            src, dst = idx[tuple(sl)], nbr[tuple(sl)]
        s, d = src.reshape(-1), dst.reshape(-1)
        I += [s, d]
        J += [d, s]
        V += [np.full(s.size, -1.0), np.full(s.size, -1.0)]
    return MtxData.from_arrays(
        np.concatenate(I), np.concatenate(J), np.concatenate(V),
        n_rows=n, n_cols=n,
    ).sort_by_row()


def spin_chain_xxz(L: int = 12, Jxy: float = 1.0, Jz: float = 1.0,
                   Bz: float = 0.0, seed: int = 1, pbc: int = 0) -> MtxData:
    """Heisenberg XXZ chain over the full 2^L basis:
    H = sum_i [ Jxy/2 (S+_i S-_{i+1} + h.c.) + Jz Sz_i Sz_{i+1} ]
        + sum_i b_i Sz_i,  b_i uniform in [-Bz, Bz]."""
    if L > 24:
        raise ValueError("spin_chain_xxz: L > 24 would exceed memory")
    dim = 1 << L
    states = np.arange(dim, dtype=np.int64)
    rng = np.random.default_rng(seed)
    fields = rng.uniform(-Bz, Bz, L) if Bz else np.zeros(L)
    bonds = [(i, (i + 1) % L) for i in range(L if pbc else L - 1)]

    # diagonal: Jz Sz Sz + field terms (Sz = +-1/2 per bit)
    sz = ((states[:, None] >> np.arange(L)[None, :]) & 1) - 0.5
    diag = (fields[None, :] * sz).sum(axis=1)
    for i, j in bonds:
        diag = diag + Jz * sz[:, i] * sz[:, j]
    I, J, V = [states], [states], [diag]

    # off-diagonal: Jxy/2 (S+ S- + S- S+) flips anti-aligned neighbor pairs
    for i, j in bonds:
        bi, bj = 1 << i, 1 << j
        anti = ((states & bi) > 0) != ((states & bj) > 0)
        src = states[anti]
        dst = src ^ (bi | bj)
        I.append(src)
        J.append(dst)
        V.append(np.full(src.size, Jxy / 2.0))
    return MtxData.from_arrays(
        np.concatenate(I), np.concatenate(J), np.concatenate(V),
        n_rows=dim, n_cols=dim,
    ).sort_by_row()


def _popcount(a: np.ndarray) -> np.ndarray:
    """Vectorized popcount of int64 arrays (numpy<2 has no bit_count)."""
    a = a.astype(np.uint64).view(np.uint8).reshape(-1, 8)
    return np.unpackbits(a, axis=1).sum(axis=1).astype(np.int64)


def _sector_states(n_sites: int, n_fermions: int) -> np.ndarray:
    """All n_sites-bit integers with exactly n_fermions set bits, ascending
    (the lexicographic occupation-number basis of one spin species)."""
    states = np.arange(1 << n_sites, dtype=np.int64)
    return states[_popcount(states) == n_fermions]


def _sector_hops(states: np.ndarray, n_sites: int, t: float, pbc: int):
    """Single-species hopping matrix -t * sum_<ij> (c+_i c_j + h.c.) within
    one occupation sector. Returns COO (src_idx, dst_idx, amp) over sector
    basis indices, including both hop directions (the matrix is symmetric).

    Fermionic sign: for a hop between sites a < b the Jordan-Wigner string
    crosses the strictly-between bits, sign = (-1)^popcount(s & between).
    Nearest-neighbor bonds have an empty string (+1); the periodic wrap bond
    (0, n-1) crosses everything in between.
    """
    bonds = [(i, i + 1) for i in range(n_sites - 1)]
    if pbc and n_sites > 2:
        bonds.append((0, n_sites - 1))
    I, J, V = [], [], []
    for a, b in bonds:
        ba, bb = np.int64(1 << a), np.int64(1 << b)
        between = np.int64(((1 << b) - 1) ^ ((1 << (a + 1)) - 1))
        # hop b -> a (occupied at b, empty at a); h.c. is generated by
        # symmetry below
        can = ((states & bb) != 0) & ((states & ba) == 0)
        src = states[can]
        if src.size == 0:
            continue
        dst = src ^ (ba | bb)
        sign = 1.0 - 2.0 * (_popcount(src & between) & 1)
        si = np.flatnonzero(can)
        di = np.searchsorted(states, dst)
        amp = -t * sign
        I += [si, di]
        J += [di, si]
        V += [amp, amp]
    if not I:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0)
    return np.concatenate(I), np.concatenate(J), np.concatenate(V)


def hubbard(n_sites: int = 10, n_fermions: int = 5, t: float = 1.0,
            U: float = 0.0, ranpot: float = 0.0, seed: int = 1,
            pbc: int = 0) -> MtxData:
    """1-D fermionic Hubbard chain at fixed filling (n_fermions per spin):

        H = -t sum_<ij>,s (c+_is c_js + h.c.) + U sum_i n_iu n_id
            + sum_i eps_i (n_iu + n_id),  eps_i uniform in [-ranpot, ranpot]

    Basis: |up> (x) |dn>, row = i_up * dim + i_dn, dim = C(n_sites,
    n_fermions) per species — the structure ScaMaC's Hubbard generator
    produces (reference bridge: utilities.hpp:1585-1752). Hops of one
    species are block-structured (kron with identity on the other), the
    interaction is diagonal.
    """
    if not (0 <= n_fermions <= n_sites):
        raise ValueError("hubbard: need 0 <= n_fermions <= n_sites")
    if n_sites > 20:
        raise ValueError("hubbard: n_sites > 20 would exceed memory")
    states = _sector_states(n_sites, n_fermions)
    d = states.size
    dim = d * d
    hi, hj, hv = _sector_hops(states, n_sites, t, pbc)
    est_nnz = dim + 2 * hi.size * d
    if est_nnz > (1 << 28):
        raise ValueError(
            f"hubbard: n_sites={n_sites}, n_fermions={n_fermions} would "
            f"generate ~{est_nnz} nonzeros; reduce the sector size"
        )

    # diagonal: U * (# doubly occupied sites) + random site potential
    docc = _popcount((states[:, None] & states[None, :]).reshape(-1))
    diag = U * docc.astype(np.float64)
    if ranpot:
        rng = np.random.default_rng(seed)
        eps = rng.uniform(-ranpot, ranpot, n_sites)
        pot1 = ((states[:, None] >> np.arange(n_sites)[None, :]) & 1) @ eps
        diag = diag + (pot1[:, None] + pot1[None, :]).reshape(-1)
    rows = np.arange(dim, dtype=np.int64)
    I, J, V = [rows], [rows], [diag]

    # up hops: kron(H_up, I_d) -> (su*d + k, du*d + k) for every k
    k = np.arange(d, dtype=np.int64)
    I.append((hi[:, None] * d + k[None, :]).reshape(-1))
    J.append((hj[:, None] * d + k[None, :]).reshape(-1))
    V.append(np.repeat(hv, d))
    # down hops: kron(I_d, H_dn) -> (k*d + sd, k*d + dd)
    I.append((k[:, None] * d + hi[None, :]).reshape(-1))
    J.append((k[:, None] * d + hj[None, :]).reshape(-1))
    V.append(np.tile(hv, d))
    return MtxData.from_arrays(
        np.concatenate(I), np.concatenate(J), np.concatenate(V),
        n_rows=dim, n_cols=dim,
    ).sort_by_row()


def free_fermion_chain(n_sites: int = 16, n_fermions: int = 8,
                       t: float = 1.0, ranpot: float = 0.0,
                       seed: int = 1, pbc: int = 0) -> MtxData:
    """Spinless free fermions on a chain at fixed filling (ScaMaC
    FreeFermionChain; reference bridge utilities.hpp:1585-1752):

        H = -t sum_<ij> (c+_i c_j + h.c.) + sum_i eps_i n_i,
        eps_i uniform in [-ranpot, ranpot]

    Basis: the C(n_sites, n_fermions) occupation sector, Jordan-Wigner
    signs on the periodic wrap bond. Quadratic Hamiltonian, but the
    many-body matrix is the sparse benchmark object."""
    if not (0 <= n_fermions <= n_sites):
        raise ValueError("freefermionchain: need 0 <= n_fermions <= n_sites")
    if n_sites > 28:
        raise ValueError("freefermionchain: n_sites > 28 exceeds memory")
    states = _sector_states(n_sites, n_fermions)
    dim = states.size
    hi, hj, hv = _sector_hops(states, n_sites, t, pbc)
    I, J, V = [hi], [hj], [hv]
    if ranpot:
        rng = np.random.default_rng(seed)
        eps = rng.uniform(-ranpot, ranpot, n_sites)
        pot = ((states[:, None] >> np.arange(n_sites)[None, :]) & 1) @ eps
        rows = np.arange(dim, dtype=np.int64)
        I.append(rows)
        J.append(rows)
        V.append(pot)
    if not any(a.size for a in I):
        rows = np.arange(dim, dtype=np.int64)
        I, J, V = [rows], [rows], [np.zeros(dim)]
    return MtxData.from_arrays(
        np.concatenate(I), np.concatenate(J), np.concatenate(V),
        n_rows=dim, n_cols=dim,
    ).sort_by_row()


def harmonic(n_bos: int = 1000, omega: float = 1.0,
             lambda_: float = 0.5) -> MtxData:
    """Single shifted harmonic oscillator in the truncated Fock basis
    (ScaMaC Harmonic; reference bridge utilities.hpp:1585-1752):

        H = omega * b+ b + lambda * (b+ + b),  dim = n_bos

    Tridiagonal with diag omega*n and off-diagonals lambda*sqrt(n+1) —
    the textbook sanity matrix of the ScaMaC catalogue."""
    if n_bos < 1:
        raise ValueError("harmonic: n_bos >= 1 required")
    n = np.arange(n_bos, dtype=np.int64)
    diag_v = omega * n.astype(np.float64)
    off = lambda_ * np.sqrt(n[:-1] + 1.0)
    I = np.concatenate([n, n[:-1], n[1:]])
    J = np.concatenate([n, n[1:], n[:-1]])
    V = np.concatenate([diag_v, off, off])
    return MtxData.from_arrays(
        I, J, V, n_rows=n_bos, n_cols=n_bos
    ).sort_by_row()


def spin_chain_xy(L: int = 14, Jx: float = 1.0, Jy: float = 1.0,
                  Bz: float = 0.0, seed: int = 1, pbc: int = 0) -> MtxData:
    """Anisotropic XY chain over the full 2^L basis (ScaMaC SpinChainXY):

        H = sum_i [ Jx Sx_i Sx_{i+1} + Jy Sy_i Sy_{i+1} ] + Bz sum_i Sz_i

    In the z-basis: (Jx+Jy)/4 flips anti-aligned neighbor pairs (the
    S+S- exchange) and (Jx-Jy)/4 flips ALIGNED pairs (the S+S+ + S-S-
    anisotropy, absent from the XXZ model) — so Jx != Jy breaks total-Sz
    conservation and fills the off-sector blocks."""
    if L > 24:
        raise ValueError("spin_chain_xy: L > 24 would exceed memory")
    dim = 1 << L
    states = np.arange(dim, dtype=np.int64)
    bonds = [(i, (i + 1) % L) for i in range(L if pbc else L - 1)]
    sz = ((states[:, None] >> np.arange(L)[None, :]) & 1) - 0.5
    diag = Bz * sz.sum(axis=1)
    I, J, V = [states], [states], [diag]
    flip = (Jx + Jy) / 4.0
    aniso = (Jx - Jy) / 4.0
    for i, j in bonds:
        bi, bj = 1 << i, 1 << j
        anti = ((states & bi) > 0) != ((states & bj) > 0)
        if flip:
            src = states[anti]
            I.append(src)
            J.append(src ^ (bi | bj))
            V.append(np.full(src.size, flip))
        if aniso:
            src = states[~anti]
            I.append(src)
            J.append(src ^ (bi | bj))
            V.append(np.full(src.size, aniso))
    return MtxData.from_arrays(
        np.concatenate(I), np.concatenate(J), np.concatenate(V),
        n_rows=dim, n_cols=dim,
    ).sort_by_row()


def bose_hubbard(n_sites: int = 8, n_bosons: int = 8, t: float = 1.0,
                 U: float = 1.0, pbc: int = 0) -> MtxData:
    """1-D Bose-Hubbard chain at fixed boson number (ScaMaC BoseHubbard):

        H = -t sum_<ij> (b+_i b_j + h.c.) + U/2 sum_i n_i (n_i - 1)

    Basis: occupation vectors (n_0..n_{L-1}) with sum = n_bosons, dim =
    C(N+L-1, N); hop amplitude -t sqrt((n_i+1) n_j) moving one boson
    j -> i."""
    from math import comb

    L, N = n_sites, n_bosons
    if L < 1 or N < 0:
        raise ValueError("bose_hubbard: need n_sites >= 1, n_bosons >= 0")
    dim = comb(N + L - 1, N)
    if dim > (1 << 21):
        raise ValueError(
            f"bose_hubbard: basis dimension {dim} would exceed memory; "
            "reduce n_sites/n_bosons"
        )
    # enumerate occupation vectors lexicographically (vectorized recursion
    # over sites: states with first occupation k, then the rest)
    occ = np.zeros((1, 0), dtype=np.int64)
    rem = np.array([N], dtype=np.int64)
    for s in range(L - 1):
        reps = rem + 1  # occupations 0..rem allowed at this site
        occ = np.repeat(occ, reps, axis=0)
        nxt = np.concatenate([np.arange(r + 1) for r in rem])
        occ = np.concatenate([occ, nxt[:, None]], axis=1)
        rem = np.repeat(rem, reps) - nxt
    occ = np.concatenate([occ, rem[:, None]], axis=1)
    assert occ.shape[0] == dim
    # rank states by encoding as mixed-radix keys for index lookup
    key_of = {tuple(row): k for k, row in enumerate(occ)}

    diag = 0.5 * U * (occ * (occ - 1)).sum(axis=1).astype(np.float64)
    rows = np.arange(dim, dtype=np.int64)
    I, J, V = [rows], [rows], [diag]
    bonds = [(i, i + 1) for i in range(L - 1)]
    if pbc and L > 2:
        bonds.append((0, L - 1))
    for a, b in bonds:
        for src_site, dst_site in ((b, a), (a, b)):  # both hop directions
            can = occ[:, src_site] > 0
            src_states = occ[can]
            amps = -t * np.sqrt(
                (src_states[:, dst_site] + 1.0) * src_states[:, src_site]
            )
            dst = src_states.copy()
            dst[:, src_site] -= 1
            dst[:, dst_site] += 1
            di = np.fromiter(
                (key_of[tuple(r)] for r in dst), dtype=np.int64,
                count=dst.shape[0],
            )
            I.append(rows[can])
            J.append(di)
            V.append(amps)
    return MtxData.from_arrays(
        np.concatenate(I), np.concatenate(J), np.concatenate(V),
        n_rows=dim, n_cols=dim,
    ).sort_by_row()


_MODELS = {
    "anderson": lambda kw: anderson(
        Lx=int(kw.pop("lx", kw.pop("l", 8))), Ly=int(kw.pop("ly", 0)),
        Lz=int(kw.pop("lz", 0)), disorder=float(kw.pop("disorder", 16.5)),
        seed=int(kw.pop("seed", 1)), pbc=int(kw.pop("pbc", 0)), **kw,
    ),
    "hubbard": lambda kw: hubbard(
        n_sites=int(kw.pop("n_sites", 10)),
        n_fermions=int(kw.pop("n_fermions", 5)),
        t=float(kw.pop("t", 1.0)), U=float(kw.pop("u", 0.0)),
        ranpot=float(kw.pop("ranpot", 0.0)), seed=int(kw.pop("seed", 1)),
        pbc=int(kw.pop("pbc", kw.pop("boundary_conditions", "open")
                        in (1, "periodic"))), **kw,
    ),
    "spinchainxxz": lambda kw: spin_chain_xxz(
        L=int(kw.pop("l", 12)), Jxy=float(kw.pop("jxy", 1.0)),
        Jz=float(kw.pop("jz", 1.0)), Bz=float(kw.pop("bz", 0.0)),
        seed=int(kw.pop("seed", 1)), pbc=int(kw.pop("pbc", 0)), **kw,
    ),
    "spinchainxy": lambda kw: spin_chain_xy(
        L=int(kw.pop("l", 14)), Jx=float(kw.pop("jx", 1.0)),
        Jy=float(kw.pop("jy", 1.0)), Bz=float(kw.pop("bz", 0.0)),
        seed=int(kw.pop("seed", 1)), pbc=int(kw.pop("pbc", 0)), **kw,
    ),
    "freefermionchain": lambda kw: free_fermion_chain(
        n_sites=int(kw.pop("n_sites", 16)),
        n_fermions=int(kw.pop("n_fermions", 8)),
        t=float(kw.pop("t", 1.0)), ranpot=float(kw.pop("ranpot", 0.0)),
        seed=int(kw.pop("seed", 1)),
        pbc=int(kw.pop("pbc", kw.pop("boundary_conditions", "open")
                        in (1, "periodic"))), **kw,
    ),
    "harmonic": lambda kw: harmonic(
        n_bos=int(kw.pop("n_bos", 1000)),
        omega=float(kw.pop("omega", 1.0)),
        lambda_=float(kw.pop("lambda", 0.5)), **kw,
    ),
    "bosehubbard": lambda kw: bose_hubbard(
        n_sites=int(kw.pop("n_sites", 8)),
        n_bosons=int(kw.pop("n_bosons", 8)),
        t=float(kw.pop("t", 1.0)), U=float(kw.pop("u", 1.0)),
        pbc=int(kw.pop("pbc", kw.pop("boundary_conditions", "open")
                        in (1, "periodic"))), **kw,
    ),
}


def scamac_models() -> tuple:
    """Names of the available ScaMaC-style models (lowercase)."""
    return tuple(_MODELS) + ("tridiagonal",)


def scamac_generate(spec: str) -> MtxData:
    """Generate a matrix from a ScaMaC-style spec string
    (reference scamac_generate, utilities.hpp:1585-1752)."""
    name, kwargs = _parse_spec(spec)
    kwargs = {k.lower(): v for k, v in kwargs.items()}
    if name == "tridiagonal":
        from .generators import tridiag

        return tridiag(
            int(kwargs.pop("n", 1000)), float(kwargs.pop("diag", 2.0)),
            float(kwargs.pop("off", -1.0)),
        )
    if name not in _MODELS:
        raise ValueError(
            f"unknown ScaMaC model {name!r}; available: "
            f"{sorted(_MODELS) + ['tridiagonal']}"
        )
    return _MODELS[name](kwargs)
