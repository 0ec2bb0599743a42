"""MatrixMarket I/O.

Port of the pure-Python path of ``uspmv_tpu/io/mmio.py`` (reference
mmio.h/mmio.cpp + read_mtx at utilities.hpp:2148-2309). Behavior:

* accepts sparse (coordinate) real / integer / pattern, general,
  symmetric or skew-symmetric; complex and hermitian are rejected;
* square matrices only unless ``require_square=False``
  (utilities.hpp:2206-2210);
* symmetric files are expanded to general by mirroring off-diagonal
  entries (utilities.hpp:2213-2267);
* entries are stable-sorted by row (sort_perm, utilities.hpp:2139-2146);
* values are read as double and cast by the caller.
"""

from __future__ import annotations

import numpy as np

from ..formats.coo import MtxData

_VALID_FORMATS = ("coordinate", "array")
_VALID_FIELDS = ("real", "integer", "pattern", "complex")
_VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


def _parse_banner(line: str):
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket" or parts[1].lower() != "matrix":
        raise ValueError(f"invalid MatrixMarket banner: {line!r}")
    fmt, field, sym = (p.lower() for p in parts[2:5])
    if fmt not in _VALID_FORMATS:
        raise ValueError(f"unknown MatrixMarket format {fmt!r}")
    if field not in _VALID_FIELDS:
        raise ValueError(f"unknown MatrixMarket field {field!r}")
    if sym not in _VALID_SYMMETRIES:
        raise ValueError(f"unknown MatrixMarket symmetry {sym!r}")
    return fmt, field, sym


def read_mtx(path: str, require_square: bool = True) -> MtxData:
    """Read a MatrixMarket file into a row-sorted COO ``MtxData`` (float64)."""
    with open(path, "rb") as f:
        data = f.read()
    text = data.decode("ascii", errors="replace")
    lines = text.split("\n")

    fmt, field, sym = _parse_banner(lines[0])
    if fmt != "coordinate":
        raise ValueError("only sparse (coordinate) MatrixMarket files are supported")
    if field == "complex":
        raise ValueError("complex matrices are not supported")
    if sym == "hermitian":
        raise ValueError("hermitian matrices are not supported")

    # skip comments / blank lines; first content line is the size line
    i = 1
    while i < len(lines) and (not lines[i].strip() or lines[i].lstrip().startswith("%")):
        i += 1
    size_parts = lines[i].split()
    n_rows, n_cols, nnz_decl = (int(p) for p in size_parts[:3])
    if require_square and n_rows != n_cols:
        raise ValueError(
            f"input matrix must be square ({n_rows}x{n_cols}); reference "
            "rejects non-square input (utilities.hpp:2206-2210)"
        )

    body = "\n".join(lines[i + 1 :])
    toks_per_entry = 2 if field == "pattern" else 3
    raw = np.array(body.split(), dtype=np.float64)
    if raw.size < nnz_decl * toks_per_entry:
        raise ValueError(
            f"file truncated: expected {nnz_decl} entries, "
            f"got {raw.size // toks_per_entry}"
        )
    raw = raw[: nnz_decl * toks_per_entry].reshape(nnz_decl, toks_per_entry)

    I = raw[:, 0].astype(np.int64) - 1
    J = raw[:, 1].astype(np.int64) - 1
    if field == "pattern":
        # reference reads pattern entries as 1.0
        vals = np.ones(nnz_decl, dtype=np.float64)
    else:
        vals = raw[:, 2]

    if (I < 0).any() or (I >= n_rows).any() or (J < 0).any() or (J >= n_cols).any():
        raise ValueError("index out of declared matrix bounds")

    is_symmetric = sym in ("symmetric", "skew-symmetric")
    if is_symmetric:
        off = I != J
        I = np.concatenate([I, J[off]])
        sign = -1.0 if sym == "skew-symmetric" else 1.0
        J = np.concatenate([J, raw[off, 0].astype(np.int64) - 1])
        vals = np.concatenate([vals, sign * vals[:nnz_decl][off]])

    mtx = MtxData.from_arrays(
        I.astype(np.int32),
        J.astype(np.int32),
        vals,
        n_rows=n_rows,
        n_cols=n_cols,
        is_symmetric=is_symmetric,
    )
    return mtx.sort_by_row()


def write_mtx(path: str, mtx: MtxData, comment: str = "") -> None:
    """Write COO to a MatrixMarket 'coordinate real general' file
    (reference mm_write_mtx_crd / ScsData::write_to_mtx_file)."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{mtx.n_rows} {mtx.n_cols} {mtx.nnz}\n")
        vals = np.asarray(mtx.values, dtype=np.float64)
        I1 = mtx.I.astype(np.int64) + 1
        J1 = mtx.J.astype(np.int64) + 1
        for i in range(mtx.nnz):
            f.write(f"{I1[i]} {J1[i]} {vals[i]:.16g}\n")
