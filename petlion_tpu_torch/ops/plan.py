"""Jacobian/solver plan: sparsity detection + coloring + structured solve
(counterpart of the JAX package's ``ops/plan.py``, colored path).

Sparsity detection runs once per model config on the CPU in float64, from
the same randomized sample states as the JAX package; the index metadata
then moves to each run's device once and stays there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics.initial_guess import initial_guess
from ..physics.residuals import ModelConfig, residual_core
from ..solver import linsolve
from .jacobian import ColoredJacobian, detect_sparsity, last_row_grad, stacked_jvp
from .structured import (device_specs, make_group_split, make_sparse_specs,
                         sparse_schur_factor, sparse_schur_solve)


class JacobianPlan:
    """Coloring + multi-group Schur factor/solve for one model config."""

    def __init__(self, cfg: ModelConfig, pattern: np.ndarray):
        self.cfg = cfg
        # the control row is computed exactly by one reverse pass and is
        # excluded from the coloring, so it is declared dense
        pattern = pattern.copy()
        pattern[-1, :] = True
        self.colored = ColoredJacobian(pattern)
        self.split = make_group_split(cfg.layout, pattern)
        self._specs = make_sparse_specs(self.colored, self.split, cfg.layout)
        self._dev = {}
        self._alg_cache = None

    @property
    def n_colors(self):
        return self.colored.n_colors

    def device_specs(self, like):
        key = (like.device, like.dtype)
        if key not in self._dev:
            self._dev[key] = device_specs(self.colored, self._specs, self.split,
                                          like.device, like.dtype)
        return self._dev[key]

    def _alg_meta(self, like):
        """Metadata of the algebraic-block colored Jacobian (consistent
        initialization), as tensors on `like`'s device."""
        if self._alg_cache is None:
            nd = self.cfg.layout.N_diff
            n = self.colored.n
            cols = np.arange(nd, n)
            used = np.unique(self.colored.colors[cols])
            remap = -np.ones(self.colored.n_colors, np.int64)
            remap[used] = np.arange(len(used))
            colors_alg = remap[self.colored.colors[cols]]
            # the substituted control row is rebuilt exactly by reverse
            # mode, so its mask row is zero
            mask = np.zeros((n - nd, n - nd))
            mask[:-1, :] = self.colored.pattern[nd:n - 1, nd:]
            seeds_alg = self.colored._seeds[used][:, nd:]
            self._alg_cache = (colors_alg, mask, seeds_alg)
        key = ("alg", like.device, like.dtype)
        if key not in self._dev:
            colors_alg, mask, seeds_alg = self._alg_cache
            kw = dict(dtype=like.dtype, device=like.device)
            self._dev[key] = (torch.as_tensor(colors_alg, device=like.device),
                              torch.as_tensor(mask, **kw),
                              torch.as_tensor(seeds_alg, **kw))
        return self._dev[key]

    def factor_alg(self, alg_res, y_alg, data: dict):
        """Colored Jacobian + equilibrated inverse of the algebraic block.

        alg_res(y_alg, data) -> (M, n_alg) is batch-first; `data` holds the
        per-cell tensors it closes over (tiled with the sweeps)."""
        colors_alg, mask, seeds = self._alg_meta(y_alg)
        JS = stacked_jvp(alg_res, y_alg, data, seeds)   # (B, n_used, n_alg)
        J = JS[:, colors_alg, :].transpose(1, 2) * mask  # J[b,i,j]=JS[b,c[j],i]
        last = last_row_grad(alg_res, y_alg, data)
        J = torch.cat([J[:, :-1], last[:, None, :]], dim=1)
        return linsolve.equilibrated_inv_factor(J)

    def factor_compressed(self, g, y, data: dict):
        """Newton-matrix factorization straight from the colored sweeps;
        neither the dense (N, N) matrix nor the coupling blocks are formed.
        g(y, data) is batch-first, `data` its per-cell tensors."""
        JS, last = self.colored.compressed(g, y, data)
        return sparse_schur_factor(JS, last, self.colored, self.device_specs(y))

    def solve(self, fac, b):
        return sparse_schur_solve(fac, b, self.device_specs(b))


_PLAN_CACHE: dict = {}


def get_plan(cfg: ModelConfig, theta: dict) -> JacobianPlan:
    """The plan for `cfg`, built once from float θ on the CPU in float64."""
    key = (cfg, tuple(sorted(theta.keys())))
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]

    kw = dict(dtype=torch.float64, device="cpu")
    th = {k: torch.tensor([[float(v)]], **kw) for k, v in theta.items()}
    L = cfg.layout

    def sample(soc, i_val, seed):
        y = initial_guess(torch.tensor([soc], **kw), th, cfg)[0].numpy().copy()
        r = np.random.default_rng(seed)
        y *= (1.0 + 0.05 * r.standard_normal(y.shape))
        y[L.sl("Phi_e")] = 0.01 * r.standard_normal(y[L.sl("Phi_e")].shape)
        y[L.sl("j")] = 1e-6 * r.standard_normal(y[L.sl("j")].shape)
        y[L.sl("I").start] = i_val
        yp = 1e-3 * r.standard_normal(y.shape)
        return torch.as_tensor(y), torch.as_tensor(yp)

    ys, yps, ts = [], [], []
    for soc, ival, seed, t in ((0.41, 0.7, 1, 13.7), (0.83, -0.6, 2, 507.1)):
        y, yp = sample(soc, ival, seed)
        ys.append(y)
        yps.append(yp)
        ts.append(t)

    def F(t, y, yp, d):
        return residual_core(t, y, yp, d, cfg)

    with torch.no_grad():
        pattern = detect_sparsity(F, ys, yps, ts, th, L.N_diff)
    plan = JacobianPlan(cfg, pattern)
    _PLAN_CACHE[key] = plan
    return plan
