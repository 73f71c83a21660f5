"""Jacobian/solver plan: sparsity detection + coloring + structured solve
(counterpart of the JAX package's ``ops/plan.py``).

Sparsity detection runs once per model config on the CPU in float64, from
the same randomized sample states as the JAX package; a plan (coloring,
elimination specs, analytic write plan) is built once per config and route,
and its index metadata moves to each run's device once and stays there.

The route selects how the Newton matrix is assembled and factored. By
default it reads the JAX package's environment variables, with the same
defaults, when the plan is built, so one setting selects the same route in
both packages:

    PETLION_JACA          "1"  analytic assembly (ops/analytic.py) where
                               supported; "0" the colored sweeps
    PETLION_NESTED        "0"  no nested levels; "1" j then Φ_s; "j" j only
    PETLION_PALLAS_BLOCKS "0"  "1": group inverses through K2 (gj_blocks)
    PETLION_PALLAS_DCHAIN "0"  "1": nested chain + core inverse through K3

The full-kernel route is ``FULL_KERNEL_ROUTE`` (all four on).

``get_plan(..., use_schur=False)`` is the JAX package's dense plan: the
colored sweeps give the dense Newton matrix, factored by the equilibrated
pivoted LU (``linsolve.equilibrated_factor``); the route's assembly and
elimination options do not apply to it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..physics.initial_guess import initial_guess
from ..physics.residuals import ModelConfig, residual_core
from ..solver import linsolve
from . import analytic as _analytic
from .jacobian import ColoredJacobian, detect_sparsity, last_row_grad, stacked_jvp
from .structured import (device_specs, make_group_split, make_sparse_specs,
                         sparse_schur_factor, sparse_schur_solve)

_NESTED = {"1": ("j", "Phi_s"), "j": ("j",), "0": ()}


@dataclasses.dataclass(frozen=True)
class Route:
    """How a plan assembles and factors the Newton matrix."""
    nested: tuple = ()        # families eliminated inside the core, in order
    blocks: bool = False      # group inverses through K2
    dchain: bool = False      # nested chain + core inverse through K3
    analytic: bool = True     # closed-form assembly where supported

    @staticmethod
    def from_env() -> "Route":
        env = os.environ.get
        return Route(nested=_NESTED.get(env("PETLION_NESTED", "0"), ()),
                     blocks=env("PETLION_PALLAS_BLOCKS", "0") != "0",
                     dchain=env("PETLION_PALLAS_DCHAIN", "0") != "0",
                     analytic=env("PETLION_JACA", "1") != "0")


FULL_KERNEL_ROUTE = Route(nested=("j", "Phi_s"), blocks=True, dchain=True)


class JacobianPlan:
    """Coloring + multi-group Schur factor/solve for one model config, or
    with `use_schur` False the colored dense matrix and its equilibrated
    pivoted LU."""

    def __init__(self, cfg: ModelConfig, pattern: np.ndarray,
                 route: Route = Route(), theta_sample: dict | None = None,
                 use_schur: bool = True):
        self.cfg = cfg
        self.route = route
        self.use_schur = use_schur
        # the control row is computed exactly by one reverse pass and is
        # excluded from the coloring, so it is declared dense
        pattern = pattern.copy()
        pattern[-1, :] = True
        self.colored = ColoredJacobian(pattern)
        self.split = self._specs = None
        if use_schur:
            self.split = make_group_split(cfg.layout, pattern)
            self._specs = make_sparse_specs(self.colored, self.split, cfg.layout,
                                            route.nested)
        # closed-form assembly where it covers the pattern, else the sweeps
        self.analytic = None
        if use_schur and route.analytic and theta_sample is not None:
            try:
                self.analytic = _analytic.AnalyticJacobian(cfg, self.colored,
                                                           theta_sample)
            except _analytic.Unsupported:
                self.analytic = None
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

    def prepare(self, like):
        """Make every device table of the plan for `like`'s device and dtype
        now, so that runs on several host threads (a mesh's shards) only
        read them."""
        if self.use_schur:
            self.device_specs(like)
        self._alg_meta(like)
        self.colored.device_tables(like)
        if self.analytic is not None:
            self.analytic._consts(like)

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

    def factor_alg(self, alg_res, y_alg, data: dict, y_diff=None, th=None):
        """Jacobian + equilibrated inverse of the algebraic block: the
        analytic block when the plan has it and θ and y_diff are given,
        else the colored sweeps. Either way the substituted control row is
        an exact reverse pass.

        alg_res(y_alg, data) -> (M, n_alg) is batch-first; `data` holds the
        per-cell tensors it closes over (tiled with the sweeps)."""
        if self.analytic is not None and th is not None and y_diff is not None:
            J = self.analytic.alg_block(torch.cat([y_diff, y_alg], dim=-1), th)
        else:
            colors_alg, mask, seeds = self._alg_meta(y_alg)
            JS = stacked_jvp(alg_res, y_alg, data, seeds)   # (B, n_used, n_alg)
            J = JS[:, colors_alg, :].transpose(1, 2) * mask  # J[b,i,j]=JS[b,c[j],i]
        last = last_row_grad(alg_res, y_alg, data)
        J = torch.cat([J[:, :-1], last[:, None, :]], dim=1)
        if self._lu_route(J):
            # the algebraic block with a derivative-hold control row needs
            # pivoting and refinement in float32, as the Newton matrix does
            return linsolve.refined_lu_factor(J)
        return linsolve.equilibrated_inv_factor(J)

    def _lu_route(self, like) -> bool:
        """float32 with the thermal model factors through the refined
        pivoted LU (as the JAX package's plan does): with a dT-hold row the
        Newton matrix reaches cond 1e14–1e16, where pivot-free elimination
        in float32 loses every digit."""
        return like.dtype == torch.float32 and self.cfg.numerics.temperature

    def factor_compressed(self, g, y, data: dict, t=None, c0=None, th=None):
        """Newton-matrix factorization straight from the analytic assembly
        (when the plan has it and t, c0 and θ are given) or the colored
        sweeps; neither the dense (N, N) matrix nor the coupling blocks are
        formed. g(y, data) is batch-first, `data` its per-cell tensors.
        float32 thermal runs take the refined pivoted LU of the dense
        colored matrix instead (`_lu_route`). Without the Schur route: the
        equilibrated pivoted LU of the dense colored matrix (float32 thermal
        too, as the JAX package's)."""
        if not self.use_schur:
            return linsolve.equilibrated_factor(self.colored(g, y, data))
        if self._lu_route(y):
            return linsolve.refined_lu_factor(self.colored(g, y, data))
        if self.analytic is not None and th is not None and c0 is not None:
            JS, last = self.analytic.compressed(t, y, c0, th, g, data)
        else:
            JS, last = self.colored.compressed(g, y, data)
        return sparse_schur_factor(JS, last, self.colored, self.device_specs(y),
                                   blocks=self.route.blocks,
                                   dchain=self.route.dchain)

    def solve(self, fac, b):
        if isinstance(fac, linsolve.EquilibratedLU):
            return linsolve.equilibrated_solve(fac, b)
        if isinstance(fac, linsolve.RefinedLU):
            return linsolve.refined_lu_solve(fac, b)
        return sparse_schur_solve(fac, b, self.device_specs(b))


_PLAN_CACHE: dict = {}       # (cfg, θ keys, route, use_schur) -> JacobianPlan
_PATTERN_CACHE: dict = {}    # (cfg, θ keys) -> detected pattern


def get_plan(cfg: ModelConfig, theta: dict, route: Route | None = None,
             use_schur: bool = True) -> JacobianPlan:
    """The plan for `cfg` on `route` (default: ``Route.from_env()``), built
    once from float θ on the CPU in float64; `use_schur` False: the dense
    plan (see the module docstring)."""
    route = Route.from_env() if route is None else route
    keys = tuple(sorted(theta.keys()))
    key = (cfg, keys, route, use_schur)
    if key not in _PLAN_CACHE:
        if (cfg, keys) not in _PATTERN_CACHE:
            _PATTERN_CACHE[(cfg, keys)] = _detect_pattern(cfg, theta)
        _PLAN_CACHE[key] = JacobianPlan(
            cfg, _PATTERN_CACHE[(cfg, keys)], route,
            theta_sample={k: float(v) for k, v in theta.items()},
            use_schur=use_schur)
    return _PLAN_CACHE[key]


def _detect_pattern(cfg: ModelConfig, theta: dict) -> np.ndarray:
    """The Newton matrix's sparsity pattern at the JAX package's sample
    states, on the CPU in float64."""
    kw = dict(dtype=torch.float64, device="cpu")
    th = {k: torch.tensor([[float(v)]], **kw) for k, v in theta.items()}
    L = cfg.layout

    def sample(soc, i_val, seed):
        y = initial_guess(torch.tensor([soc], **kw), th, cfg)[0].numpy().copy()
        r = np.random.default_rng(seed)
        y *= (1.0 + 0.05 * r.standard_normal(y.shape))
        y[L.sl("Phi_e")] = 0.01 * r.standard_normal(y[L.sl("Phi_e")].shape)
        y[L.sl("j")] = 1e-6 * r.standard_normal(y[L.sl("j")].shape)
        if "T" in L:   # the T state is an offset from T_amb, may start at 0
            y[L.sl("T")] = y[L.sl("T")] + 2.0 * r.standard_normal(y[L.sl("T")].shape)
        if "j_s" in L:
            y[L.sl("j_s")] = -1e-7 * r.random(y[L.sl("j_s")].shape)
        if "film" in L:
            y[L.sl("film")] = 1e-9 * r.random(y[L.sl("film")].shape)
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
        return detect_sparsity(F, ys, yps, ts, th, L.N_diff)
