"""sparse_tpu_torch's column-indexed DIA SpMV against sparse_tpu, on the CPU.

``dia_spmv_direct`` runs its plain version here (the kernel's sum, term for
term in the same order); it is held against sparse_tpu's
``dia_spmv_pallas`` in interpret mode on tests/test_dia_spmv.py's cases
and wide matrices. Tolerances: rtol 1e-12 in f64 (the two sum the same
products in another association); in f32 each row within D * eps * sum_k
|a * x|, the bound of a D-term sum taken in two orders.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sparse_tpu.kernels.dia_spmv import dia_spmv_pallas

from sparse_tpu_torch.kernels.dia_spmv import dia_spmv_direct, dia_spmv_direct_plain

CASES = [
    (50, 50, [-5, -1, 0, 1, 5]),
    (40, 60, [-3, 0, 2, 10]),
    (60, 40, [-7, 0, 1]),
    (7, 7, [0]),
    (300, 300, [-17, -1, 0, 1, 17]),
    (100, 390, [0, 5]),  # tests/test_dia_spmv.py:132-139's wide matrix
    (100, 2000, [0, 5]),
]


def _inputs(m, n, offs, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(offs), n)).astype(dtype), rng.standard_normal(n).astype(dtype)


@pytest.mark.parametrize("m,n,offs", CASES)
def test_direct_matches_reference_f64(m, n, offs):
    data, x = _inputs(m, n, offs, np.float64, m + n)
    want = np.asarray(dia_spmv_pallas(data, tuple(offs), x, (m, n), interpret=True))
    got = dia_spmv_direct(torch.from_numpy(data), offs, torch.from_numpy(x), (m, n))
    assert got.dtype == torch.float64 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), sp.dia_matrix((data, offs), shape=(m, n)) @ x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n,offs", CASES)
def test_direct_matches_reference_f32(m, n, offs):
    data, x = _inputs(m, n, offs, np.float32, 3 * m + n)
    want = np.asarray(dia_spmv_pallas(data, tuple(offs), x, (m, n), interpret=True))
    got = dia_spmv_direct(torch.from_numpy(data), offs, torch.from_numpy(x), (m, n)).numpy()
    assert got.dtype == np.float32
    mag = sp.dia_matrix((np.abs(data).astype(np.float64), offs), shape=(m, n)) @ np.abs(x)
    bound = len(offs) * np.finfo(np.float32).eps * mag
    assert np.all(np.abs(got.astype(np.float64) - want.astype(np.float64)) <= bound)


def test_direct_reads_planes_in_place_of_any_width():
    """Planes narrower or wider than n: columns past either end are zero."""
    rng = np.random.default_rng(2)
    m, n, offs = 30, 40, (-2, 0, 3)
    x = rng.standard_normal(n)
    for width in (25, 40, 55):
        data = rng.standard_normal((3, width))
        cut = np.zeros((3, n))
        cut[:, : min(width, n)] = data[:, :n]
        want = sp.dia_matrix((cut, offs), shape=(m, n)) @ x
        got = dia_spmv_direct(torch.from_numpy(data), offs, torch.from_numpy(x), (m, n))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_direct_plain_sums_in_offset_order():
    """The plain version is the kernel's sum: ((0 + t_0) + t_1) + ..., each
    term rounded once, in f32."""
    data, x = _inputs(64, 64, [-3, 0, 1], np.float32, 9)
    got = dia_spmv_direct_plain(torch.from_numpy(data), (-3, 0, 1), torch.from_numpy(x), (64, 64))
    acc = np.zeros(64, np.float32)
    for k, o in enumerate((-3, 0, 1)):
        i = np.arange(64)
        j = i + o
        ok = (j >= 0) & (j < 64)
        term = np.zeros(64, np.float32)
        term[ok] = data[k, j[ok]] * x[j[ok]]
        acc = acc + term
    assert np.array_equal(got.numpy(), acc)


def test_direct_checks_shapes():
    data = torch.ones((2, 10))
    with pytest.raises(ValueError, match="dia_spmv_direct"):
        dia_spmv_direct(data, (0,), torch.ones(10), (10, 10))
    with pytest.raises(ValueError, match="dia_spmv_direct"):
        dia_spmv_direct(data, (0, 1), torch.ones(9), (10, 10))
    assert dia_spmv_direct(data, (0, 1), torch.ones(10), (0, 10)).shape == (0,)
