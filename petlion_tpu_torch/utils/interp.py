"""Interpolation of saved outputs on the host (counterpart of the JAX
package's ``utils/interp.py``).

``hermite_interp`` uses the solver's stored derivatives; ``spline_interp`` is
a natural cubic spline, through the port's native C++ runtime
(``runtime/native.py``) when it is built, else through its plain numpy
version (a Thomas tridiagonal solve, ``_cubic_coeffs``).
"""

from __future__ import annotations

import numpy as np

_native = None


def _load_native():
    global _native
    if _native is None:
        from ..runtime import native
        _native = native if native.available() else False
    return _native


def _cubic_coeffs(t, y):
    """Natural cubic spline second derivatives (Thomas algorithm)."""
    n = len(t)
    h = np.diff(t)
    # guard against repeated knots
    h = np.where(h <= 0, 1e-300, h)
    a = np.zeros(n)
    b = np.ones(n)
    c = np.zeros(n)
    d = np.zeros(y.shape)
    if n > 2:
        a[1:-1] = h[:-1]
        b[1:-1] = 2.0 * (h[:-1] + h[1:])
        c[1:-1] = h[1:]
        d[1:-1] = 6.0 * ((y[2:] - y[1:-1]) / h[1:, None] if y.ndim > 1
                         else (y[2:] - y[1:-1]) / h[1:])
        d[1:-1] -= 6.0 * ((y[1:-1] - y[:-2]) / h[:-1, None] if y.ndim > 1
                          else (y[1:-1] - y[:-2]) / h[:-1])
    # Thomas solve
    n_ = n
    cp = np.zeros(n_)
    dp = np.zeros(d.shape)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, n_):
        m = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / m
        dp[i] = (d[i] - a[i] * dp[i - 1]) / m
    M = np.zeros(d.shape)
    M[-1] = dp[-1]
    for i in range(n_ - 2, -1, -1):
        M[i] = dp[i] - cp[i] * M[i + 1]
    return M


def hermite_interp(t, y, yp, t_query, extrapolate=False):
    """Piecewise cubic Hermite using the solver's stored derivatives.

    Where the natural cubic spline (Dierckx replacement) infers curvature
    from the data, the solver *knows* dY/dt at every accepted step (the
    recorded YP), so the Hermite interpolant is locally 4th-order accurate
    with no boundary-condition ambiguity. Used by ``Solution.__call__`` for
    the Y array when YP was recorded."""
    t = np.asarray(t, float)
    y = np.asarray(y, float)
    yp = np.asarray(yp, float)
    t_query = np.asarray(t_query, float)
    if len(t) == 1:
        return np.broadcast_to(y[0], t_query.shape + y.shape[1:]).copy()
    tq = t_query if extrapolate else np.clip(t_query, t[0], t[-1])
    idx = np.clip(np.searchsorted(t, tq) - 1, 0, len(t) - 2)
    h = t[idx + 1] - t[idx]
    h = np.where(h <= 0, 1e-300, h)
    s = (tq - t[idx]) / h
    if y.ndim > 1:
        s = s[:, None]
        h = h[:, None]
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s**2 * (3 - 2 * s)
    h11 = s**2 * (s - 1)
    return (h00 * y[idx] + h01 * y[idx + 1]
            + h * (h10 * yp[idx] + h11 * yp[idx + 1]))


def spline_interp(t, y, t_query, extrapolate=False):
    """Natural cubic spline evaluation; y may be (n,) or (n, m)."""
    t = np.asarray(t, float)
    y = np.asarray(y, float)
    t_query = np.asarray(t_query, float)
    if len(t) == 1:
        return np.broadcast_to(y[0], t_query.shape + y.shape[1:]).copy()
    if len(t) < 4:
        # too few points for a cubic — linear
        if y.ndim == 1:
            return np.interp(t_query, t, y)
        return np.stack([np.interp(t_query, t, y[:, j])
                         for j in range(y.shape[1])], axis=-1)

    native = _load_native()
    if native:
        return native.spline_interp(t, y, t_query, extrapolate)

    M = _cubic_coeffs(t, y)
    tq = t_query if extrapolate else np.clip(t_query, t[0], t[-1])
    idx = np.clip(np.searchsorted(t, tq) - 1, 0, len(t) - 2)
    h = t[idx + 1] - t[idx]
    A = (t[idx + 1] - tq) / h
    B = (tq - t[idx]) / h
    if y.ndim > 1:
        A = A[:, None]
        B = B[:, None]
        h = h[:, None]
    C = (A**3 - A) * h**2 / 6.0
    D = (B**3 - B) * h**2 / 6.0
    return A * y[idx] + B * y[idx + 1] + C * M[idx] + D * M[idx + 1]
