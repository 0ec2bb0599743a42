"""The reference's golden fixtures, held against uspmv_tpu_torch.

``tests/test_golden.py`` holds the JAX package to the C++ suite's
hand-written fixtures (test_suite/test_data/M_big.cpp:1-253, driven by
test_suite/tests.cpp:141-275): the 10x10 M_big matrix, its magnitude split
at threshold 1.0 into the high- and low-precision sub-matrices, and their
SELL-C-sigma structures at (C=1, sigma=2) and (C=1, sigma=128). This file
restates those fixtures and holds the port's ``partition_precisions`` and
``convert_to_scs`` to them, the Python converter and the native one
(``native/uspmv_host.cpp``, built with g++ at first use) alike.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from uspmv_tpu_torch.formats.coo import MtxData
from uspmv_tpu_torch.formats.scs import convert_to_scs
from uspmv_tpu_torch.precision.partition import partition_precisions

# reference M_big (test_data/M_big.cpp:4-13)
M_BIG = dict(
    I=[0, 0, 0, 1, 2, 2, 2, 3, 4, 5, 5, 5, 6, 7, 7, 7, 8, 9],
    J=[0, 3, 4, 1, 0, 1, 2, 3, 4, 5, 8, 9, 6, 5, 6, 7, 8, 9],
    values=[.11, 14, 15, .22, 31, 32, .33, 44, 55, .66, 69, .610,
            77, 86, 87, 88, .99, 1010],
)

# exp_M_big_lp (M_big.cpp:16-26) and exp_M_big_hp (M_big.cpp:136-145)
SPLIT = {
    "sp": dict(I=[0, 1, 2, 5, 5, 8], J=[0, 1, 2, 5, 9, 8],
               values=[.11, .22, .33, .66, .610, .99]),
    "dp": dict(I=[0, 0, 2, 2, 3, 4, 5, 6, 7, 7, 7, 9],
               J=[3, 4, 0, 1, 3, 4, 8, 6, 5, 6, 7, 9],
               values=[14, 15, 31, 32, 44, 55, 69, 77, 86, 87, 88, 1010]),
}

# explicit_exp_M_big_{lp,hp}_scs_1_{2,128} (M_big.cpp:44-51, 98-105,
# 165-172, 219-226)
SCS = {
    ("sp", 2): dict(
        chunk_ptrs=[0, 1, 2, 3, 3, 5, 5, 5, 5, 6, 6],
        chunk_lengths=[1, 1, 1, 0, 2, 0, 0, 0, 1, 0],
        col_idxs=[0, 1, 2, 5, 9, 8],
        values=[.11, .22, .33, .66, .610, .99],
        old_to_new=[0, 1, 2, 3, 5, 4, 6, 7, 8, 9],
        new_to_old=[0, 1, 2, 3, 5, 4, 6, 7, 8, 9]),
    ("sp", 128): dict(
        chunk_ptrs=[0, 2, 3, 4, 5, 6, 6, 6, 6, 6, 6],
        chunk_lengths=[2, 1, 1, 1, 1, 0, 0, 0, 0, 0],
        col_idxs=[5, 9, 0, 1, 2, 8],
        values=[.66, .610, .11, .22, .33, .99],
        old_to_new=[1, 2, 3, 5, 6, 0, 7, 8, 4, 9],
        new_to_old=[5, 0, 1, 2, 8, 3, 4, 6, 7, 9]),
    ("dp", 2): dict(
        chunk_ptrs=[0, 2, 2, 4, 5, 6, 7, 10, 11, 12, 12],
        chunk_lengths=[2, 0, 2, 1, 1, 1, 3, 1, 1, 0],
        col_idxs=[3, 4, 0, 1, 3, 4, 8, 5, 6, 7, 6, 9],
        values=[14, 15, 31, 32, 44, 55, 69, 86, 87, 88, 77, 1010],
        old_to_new=[0, 1, 2, 3, 4, 5, 7, 6, 9, 8],
        new_to_old=[0, 1, 2, 3, 4, 5, 7, 6, 9, 8]),
    ("dp", 128): dict(
        chunk_ptrs=[0, 3, 5, 7, 8, 9, 10, 11, 12, 12, 12],
        chunk_lengths=[3, 2, 2, 1, 1, 1, 1, 1, 0, 0],
        col_idxs=[5, 6, 7, 3, 4, 0, 1, 3, 4, 8, 6, 9],
        values=[86, 87, 88, 14, 15, 31, 32, 44, 55, 69, 77, 1010],
        old_to_new=[1, 8, 2, 3, 4, 5, 6, 0, 9, 7],
        new_to_old=[7, 0, 2, 3, 4, 5, 6, 9, 1, 8]),
}


@pytest.fixture
def split():
    """The magnitude split at threshold 1.0 (the ancestor
    seperate_lp_from_hp, tests.cpp:8-24): dp = |a| >= 1, sp = |a| < 1."""
    m = MtxData.from_arrays(n_rows=10, n_cols=10, is_sorted=True, **M_BIG)
    subs, dropped = partition_precisions(m, "ap[dp_sp]", 1.0)
    assert dropped == 0
    return subs


@pytest.mark.parametrize("prec", ["sp", "dp"])
def test_split_matches_reference_fixtures(split, prec):
    want = SPLIT[prec]
    np.testing.assert_array_equal(split[prec].I, want["I"])
    np.testing.assert_array_equal(split[prec].J, want["J"])
    # sp values are f32 roundings of the fixture's decimals
    np.testing.assert_allclose(split[prec].values.astype(np.float64),
                               want["values"],
                               rtol=1e-6 if prec == "sp" else 0)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("prec,sigma", sorted(SCS))
def test_scs_matches_reference_fixtures(split, prec, sigma, native):
    scs = convert_to_scs(split[prec], 1, sigma, native=native)
    want = SCS[(prec, sigma)]
    np.testing.assert_array_equal(scs.chunk_ptrs, want["chunk_ptrs"])
    np.testing.assert_array_equal(scs.chunk_lengths, want["chunk_lengths"])
    np.testing.assert_array_equal(scs.col_idxs, want["col_idxs"])
    np.testing.assert_allclose(scs.values.astype(np.float64), want["values"],
                               rtol=1e-6 if prec == "sp" else 0)
    np.testing.assert_array_equal(scs.old_to_new_idx, want["old_to_new"])
    np.testing.assert_array_equal(scs.new_to_old_idx, want["new_to_old"])
    assert (scs.C, scs.sigma, scs.n_rows, scs.n_chunks) == (1, sigma, 10, 10)
    assert scs.nnz == scs.n_elements == len(want["col_idxs"])
    # C = 1 is CRS: the chunk pointers are the row pointers
    ptrs, cols, vals = scs.to_crs()
    np.testing.assert_array_equal(ptrs, want["chunk_ptrs"])
    np.testing.assert_array_equal(cols, want["col_idxs"])
    dense = np.zeros((10, 10))
    dense[split[prec].I, split[prec].J] = split[prec].values
    np.testing.assert_array_equal(scs.to_dense(), dense)
