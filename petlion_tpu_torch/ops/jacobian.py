"""Compressed (colored) Jacobian evaluation (counterpart of
the JAX package's ``ops/jacobian.py``).

1. The sparsity pattern is detected once per model config from dense
   Jacobians at a few randomized states (plus the differential diagonal).
2. Greedy column coloring partitions the columns into groups whose columns
   never share a row, so the Jacobian is recovered from one JVP per color.
3. The control (last) row is excluded from the coloring and evaluated by
   one reverse-mode pass.

Batch-first: the residual is a function of ``(M, N)`` rows whose per-row
data (θ, setpoint, BDF coefficients) travels in a dict of tensors with the
same leading axis. Cells never couple, so the sweeps of all colors and all
cells are ONE Jacobian-vector product over a ``(n_colors·B, N)`` stack.
The dense Jacobian of the dense routes (the JAX package's `jax.jacfwd`) is
the same pass over the N identity seeds, an ``(N·B, N)`` stack.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .dual import dual_constant, grad_leaf, grad_seed


def tile_rows(data: dict, reps: int) -> dict:
    """Repeat every per-row tensor of `data` `reps` times along axis 0
    (block-major: row r·B + b is cell b)."""
    return {k: v.repeat((reps,) + (1,) * (v.ndim - 1)) for k, v in data.items()}


def stacked_jvp(g: Callable, y, data: dict, seeds):
    """All sweeps g'(y)·s for `seeds` (S, N) and every row of y (B, N) in
    one forward-mode pass; returns (B, S, N)."""
    B, N = y.shape
    S = seeds.shape[0]
    Y = y.repeat(S, 1)
    T = seeds.repeat_interleave(B, dim=0)
    data_r = tile_rows(data, S)
    # J·T by the double-vjp trick: u ↦ Jᵀu is linear in u, so its vjp with
    # T is J·T. Forward-mode dual tensors (and torch.func.jvp) send every op
    # with a constant operand through a slow Python-level zero-tangent path;
    # reverse mode twice runs at native speed. A forward-mode tangent of y or
    # of `data` (parameter estimation) rides through both passes.
    with torch.enable_grad():
        Yr = grad_leaf(Y)
        out = g(Yr, data_r)
        u = grad_seed(out, 0.0)
        u = (torch.zeros_like(out) if u is None else u).requires_grad_(True)
        (gY,) = torch.autograd.grad(out, Yr, u, create_graph=True)
        (JT,) = torch.autograd.grad(gY, u, dual_constant(T, gY))
    return JT.reshape(S, B, -1).transpose(0, 1)


def dense_jacobian(g: Callable, y, data: dict):
    """The dense Jacobian ∂g(y)/∂y of every row, (B, M, N), in one stacked
    pass over the N identity seeds: N·B rows, so its memory grows as B·N²."""
    eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    return stacked_jvp(g, y, data, eye).transpose(1, 2)


# keys under which the per-cell BDF data of the Newton system rides along
# with θ through the tiled sweeps
_T, _C0, _CONST = "_t", "_c0", "_const"


def newton_system(F: Callable, data: dict, t, y_pred, c0, psi_over_h):
    """(g, d): the map y ↦ F(t, y, c0·y + const) with const = psi_over_h −
    c0·y_pred, whose Jacobian is the Newton matrix ∂F/∂y + c0·∂F/∂yp, as
    g(y, d) over `data` with each cell's t, c0 and const added to d.
    F(t, y, yp, data) is batch-first; t, c0 (B,), y_pred, psi_over_h (B, N)."""
    d = dict(data)
    d[_T] = t[:, None]
    d[_C0] = c0[:, None]
    d[_CONST] = psi_over_h - c0[:, None] * y_pred

    def g(yy, dd):
        return F(dd[_T][:, 0], yy, dd[_C0] * yy + dd[_CONST], dd)
    return g, d


def last_row_grad(g: Callable, y, data: dict):
    """∂g(y)[:, -1]/∂y for every row, by one reverse pass, (B, N)."""
    with torch.enable_grad():
        yy = grad_leaf(y)
        out = g(yy, data)[:, -1].sum()
        return torch.autograd.grad(out, yy, grad_seed(out))[0]


def detect_sparsity(F: Callable, y_samples, yp_samples, t_samples, data: dict,
                    n_diff: int, threshold=0.0) -> np.ndarray:
    """Boolean (N, N) pattern of ∂F/∂y + ∂F/∂yp over sample states.

    F(t, y, yp, data) is batch-first; each sample is a (N,) tensor and
    `data` holds the (1, ...) per-row tensors of one cell."""
    pat = None
    for y, yp, t in zip(y_samples, yp_samples, t_samples):
        n = y.shape[-1]
        eye = torch.eye(n, dtype=y.dtype, device=y.device)
        Jy = stacked_jvp(lambda yy, d: F(t, yy, yp[None].expand_as(yy), d),
                         y[None], data, eye)[0]
        Jp = stacked_jvp(lambda pp, d: F(t, y[None].expand_as(pp), pp, d),
                         yp[None], data, eye)[0]
        # rows of Jy/Jp are seeds (columns of J): transpose to J[i, j]
        m = (np.abs(Jy.T.cpu().numpy()) > threshold) | \
            (np.abs(Jp.T.cpu().numpy()) > threshold)
        pat = m if pat is None else (pat | m)
    n = pat.shape[0]
    idx = np.arange(n_diff)
    pat[idx, idx] = True
    pat[n - 1, n - 1] = True
    return pat


def greedy_color(pattern: np.ndarray, skip_last_row: bool = True):
    """Column coloring: columns sharing a nonzero row get different colors."""
    pat = pattern.copy()
    if skip_last_row:
        pat = pat[:-1, :]
    n = pat.shape[1]
    rows_of = [np.nonzero(pat[:, j])[0] for j in range(n)]
    colors = -np.ones(n, dtype=np.int32)
    masks = []
    for j in range(n):
        rs = rows_of[j]
        c = 0
        while True:
            if c == len(masks):
                masks.append(np.zeros(pat.shape[0], dtype=bool))
            if not masks[c][rs].any():
                colors[j] = c
                masks[c][rs] = True
                break
            c += 1
    return colors, len(masks)


class ColoredJacobian:
    """Precomputed coloring for one model config (host numpy metadata)."""

    def __init__(self, pattern: np.ndarray):
        self.pattern = pattern
        self.colors, self.n_colors = greedy_color(pattern)
        n = pattern.shape[0]
        self.n = n
        seeds = np.zeros((self.n_colors, n), dtype=np.float64)
        seeds[self.colors, np.arange(n)] = 1.0
        self._seeds = seeds
        self._seeds_dev = {}    # (device, dtype) -> seeds, colors, dense mask
        self._mask = pattern.astype(np.float64)
        # the last row is computed exactly by a reverse pass
        self._mask_body = self._mask.copy()
        self._mask_body[-1, :] = 0.0

    def compressed(self, g: Callable, y, data: dict):
        """(JS, last_row): JS (B, n_colors, N) holds the colored sweeps,
        J[b, i, j] = JS[b, color[j], i] on the pattern; last_row (B, N)."""
        return (stacked_jvp(g, y, data, self.device_tables(y)[0]),
                last_row_grad(g, y, data))

    def device_tables(self, like):
        """(seeds, colors, mask) as tensors on `like`'s device and dtype,
        made once per device and dtype."""
        key = (like.device, like.dtype)
        if key not in self._seeds_dev:
            self._seeds_dev[key] = (
                torch.as_tensor(self._seeds, dtype=like.dtype, device=like.device),
                torch.as_tensor(self.colors, dtype=torch.int64, device=like.device),
                torch.as_tensor(self._mask_body, dtype=like.dtype, device=like.device))
        return self._seeds_dev[key]

    def __call__(self, g: Callable, y, data: dict):
        """The dense Newton matrix (B, N, N) from the colored sweeps (on the
        pattern) and the exact control row."""
        JS, last = self.compressed(g, y, data)
        _, colors, mask = self.device_tables(y)
        J = JS[:, colors, :].transpose(1, 2) * mask     # J[b,i,j] = JS[b,c[j],i]
        return torch.cat([J[:, :-1], last[:, None, :]], dim=1)

    def submatrix_spec(self, rows: np.ndarray, cols: np.ndarray):
        """Static metadata to extract J[rows, cols] from (JS, last_row)."""
        color_cols = self.colors[cols]
        mask = self._mask_body[np.ix_(rows, cols)]
        last_rows = np.nonzero(rows == self.n - 1)[0]
        return (np.asarray(rows), np.asarray(cols),
                np.asarray(color_cols), mask.astype(np.float64),
                int(last_rows[0]) if len(last_rows) else -1)

    @staticmethod
    def submatrix(JS, last_row, spec):
        """J[:, rows, cols] (B, n_rows, n_cols); spec entries may be numpy
        or tensors on JS's device."""
        rows, cols, color_cols, mask, last_pos = spec
        dev = JS.device
        rows = torch.as_tensor(rows, device=dev)
        cols = torch.as_tensor(cols, device=dev)
        color_cols = torch.as_tensor(color_cols, device=dev)
        mask = torch.as_tensor(mask, dtype=JS.dtype, device=dev)
        M = JS[:, color_cols[None, :], rows[:, None]] * mask
        if last_pos >= 0:
            M = torch.cat([M[:, :last_pos], last_row[:, None, cols],
                           M[:, last_pos + 1:]], dim=1)
        return M
