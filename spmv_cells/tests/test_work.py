"""The yardstick: the generator's nonzeros against their closed form, and
the byte counts of the cells."""

import numpy as np
import pytest

from spmv_cells.lib import spec, work


@pytest.mark.parametrize("grid", [(3, 4, 5), (8, 8, 8), (6, 5, 24)])
def test_hpcg_nnz_closed_form(grid):
    params = dict(zip(("nx", "ny", "nz"), grid))
    gen = spec.generator("hpcg")
    n, _, I, J, V = gen.generate(params)
    assert n == np.prod(grid) and V.size == gen.nnz(params)
    assert V.size == np.prod([3 * g - 2 for g in grid])
    assert (np.diff(I) >= 0).all() and I.dtype == J.dtype == np.int32
    counts = np.bincount(I, minlength=n)
    assert counts.max() == 27 and (V[J == I] == 26.0).all()
    assert (V[J != I] == -1.0).all()
    # columns ascend within each row
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    step = np.diff(J.astype(np.int64))
    step[starts[1:] - 1] = 1
    assert (step > 0).all()


@pytest.mark.parametrize("grid", [(3, 4, 5), (1, 2, 3), (2, 2, 1)])
def test_hpcg_equals_the_reference_loops(grid):
    """Row by row as GenerateProblem_ref.cpp's loops build it."""
    nx, ny, nz = grid
    I, J, V = [], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                row = ix + nx * (iy + ny * iz)
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            z, y, x = iz + sz, iy + sy, ix + sx
                            if 0 <= z < nz and 0 <= y < ny and 0 <= x < nx:
                                col = x + nx * (y + ny * z)
                                I.append(row)
                                J.append(col)
                                V.append(26.0 if col == row else -1.0)
    n, _, gi, gj, gv = spec.generator("hpcg").generate(
        {"nx": nx, "ny": ny, "nz": nz})
    assert n == nx * ny * nz
    np.testing.assert_array_equal(gi, I)
    np.testing.assert_array_equal(gj, J)
    np.testing.assert_array_equal(gv, V)


def test_hpcg_256_sizes():
    conf = spec.config("hpcg_256")
    p = conf["params"]
    assert conf["nnz"] == spec.generator("hpcg").nnz(p)
    assert conf["n_rows"] == p["nx"] * p["ny"] * p["nz"] == 256 ** 3
    assert conf["nnz"] == (3 * 256 - 2) ** 3 == 449455096


def test_cell_bytes():
    """The benchmark's bytes per SpMV of the cell: matrix once (value and
    4-byte column), x read once, y written once."""
    c = spec.config("hpcg_256")
    assert work.bytes_per_spmv(c["nnz"], c["n_rows"], c["n_rows"], "dp",
                               1) == 449455096 * 12 + 16777216 * 16 \
        == 5661896608
    assert work.bytes_per_spmv(1000, 10, 20, "sp", 8) == \
        1000 * 8 + (10 + 20) * 8 * 4
    assert work.flops_per_spmv(449455096, 1) == 898910192


def test_peak_table():
    assert work.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert work.hbm_bytes_per_s("NVIDIA H100 NVL") == 3.9e12
    assert work.hbm_bytes_per_s("cpu") is None
