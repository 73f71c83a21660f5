"""The port's native host runtime (its own `csrc/native.cpp`, built with g++
into `build/native/`) against the JAX package's binding of its C++ runtime,
and the port's numpy spline against the native one, on seeded inputs."""

import shutil

import numpy as np
import pytest

from petlion_tpu.runtime import native as jax_native
from petlion_tpu.utils import interp as jax_interp
from petlion_tpu_torch.runtime import native
from petlion_tpu_torch.utils import interp


@pytest.fixture(scope="module", autouse=True)
def require_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port's native runtime cannot be built")
    assert native.available()
    # built from the port's own source into build/native/, never csrc/
    so = native._so_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert native.SOURCE.parent.parent.name == "petlion_tpu_torch"
    if not jax_native.available():
        pytest.skip("the JAX package's native runtime did not load")


def _data(seed, n, m):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 10.0, n))
    y = np.sin(t)[:, None] * rng.standard_normal((1, m)) + 0.1 * rng.standard_normal((n, m))
    return t, y


@pytest.mark.parametrize("n, m, extrapolate", [(25, 3, False), (25, 3, True),
                                               (3, 2, False), (200, 1, True)])
def test_spline_matches_jax_binding(n, m, extrapolate):
    """Natural cubic spline (linear below 4 knots), with and without
    extrapolation, 1-D and 2-D values: the port's build = the JAX
    package's to 1e-12."""
    t, y = _data(n * 10 + m, n, m)
    tq = np.linspace(-1.0, 11.0, 57)
    got = native.spline_interp(t, y, tq, extrapolate)
    want = jax_native.spline_interp(t, y, tq, extrapolate)
    assert got.shape == (57, m)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(native.spline_interp(t, y[:, 0], tq, extrapolate),
                               want[:, 0], rtol=0, atol=1e-12)


def test_plain_spline_matches_native(monkeypatch):
    """The numpy Thomas-solve spline (the plain version) = the native
    library, through `utils.interp.spline_interp`; and with the library the
    port's interp = the JAX package's."""
    t, y = _data(7, 30, 4)
    tq = np.linspace(0.0, 10.0, 41)
    for extrapolate in (False, True):
        with_native = interp.spline_interp(t, y, tq, extrapolate)
        np.testing.assert_allclose(with_native,
                                   jax_interp.spline_interp(t, y, tq, extrapolate),
                                   rtol=0, atol=1e-12)
        monkeypatch.setattr(interp, "_native", False)
        plain = interp.spline_interp(t, y, tq, extrapolate)
        monkeypatch.undo()
        np.testing.assert_allclose(plain, with_native, rtol=0, atol=1e-12)


def test_banded_arrow_solve_matches_jax_binding():
    """The bordered banded LU on a P2D-like matrix (band plus dense last
    row and column) = the JAX binding to 1e-12, and solves the system."""
    rng = np.random.default_rng(1)
    n, kl, ku = 121, 12, 12
    A = np.zeros((n, n))
    for i in range(n - 1):
        lo, hi = max(0, i - kl), min(n - 1, i + ku + 1)
        A[i, lo:hi] = rng.standard_normal(hi - lo)
        A[i, i] += 3.0 * (kl + ku)
    A[-1, :] = rng.standard_normal(n)
    A[:, -1] = rng.standard_normal(n)
    A[-1, -1] += 10.0
    b = rng.standard_normal(n)
    A_in = A.copy()
    x = native.banded_arrow_solve(A, b, kl, ku)
    np.testing.assert_array_equal(A, A_in)
    np.testing.assert_allclose(x, jax_native.banded_arrow_solve(A, b, kl, ku),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(A @ x, b, rtol=0, atol=1e-10)
    with pytest.raises(ValueError):
        native.banded_arrow_solve(A, b[:-1], kl, ku)
