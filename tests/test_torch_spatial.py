"""sparse_tpu_torch.spatial.cdist against sparse_tpu.spatial.cdist and scipy
on the CPU (mirrors tests/test_spatial.py). The same seeded points go to
both packages; f64 distances agree to 1e-12 relative (both are the same
norms-and-matmul formula; the matmuls sum in their own orders) and to
scipy's direct differences to 1e-10."""

import numpy as np
import pytest
import scipy.spatial.distance as sd

from sparse_tpu import spatial as jspatial

import sparse_tpu_torch as st
from sparse_tpu_torch import spatial


@pytest.fixture(autouse=True)
def _cpu():
    old = st.settings.device
    st.settings.device = "cpu"
    yield
    st.settings.device = old


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cityblock"])
@pytest.mark.parametrize("m,n,k", [(10, 7, 3), (33, 33, 8), (1, 5, 2)])
def test_cdist_equals_reference(metric, m, n, k):
    rng = np.random.default_rng(m * 100 + k)
    XA, XB = rng.standard_normal((m, k)), rng.standard_normal((n, k))
    d = spatial.cdist(XA, XB, metric).numpy()
    ref = np.asarray(jspatial.cdist(XA, XB, metric))
    np.testing.assert_allclose(d, ref, rtol=1e-12, atol=1e-12 * ref.max())
    np.testing.assert_allclose(d, sd.cdist(XA, XB, metric), rtol=1e-10, atol=1e-12)


def test_cdist_float32_and_errors():
    rng = np.random.default_rng(1)
    XA = rng.standard_normal((9, 4)).astype(np.float32)
    XB = rng.standard_normal((6, 4)).astype(np.float32)
    d = spatial.cdist(XA, XB)
    assert d.dtype.is_floating_point and d.dtype.itemsize == 4
    np.testing.assert_allclose(d.numpy(), sd.cdist(XA, XB), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        spatial.cdist(np.zeros((3, 2)), np.zeros((3, 4)))
    with pytest.raises(ValueError):
        spatial.cdist(np.zeros(3), np.zeros((3, 4)))
    with pytest.raises(ValueError):
        spatial.cdist(np.zeros((3, 2)), np.zeros((3, 2)), metric="cosine")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        spatial.cdist(XA, XB, mesh=object())
