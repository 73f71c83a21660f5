"""The port's main paths, defined once, and where their time goes on the card.

The main path is the program of the JAX package's ``bench.py:make_runner``:
``B_MAIN`` = 1024 LCO cells, isothermal, Fickian finite-difference radial
diffusion, the default mesh, a 1C discharge from SOC 1 (``I=-1``, ``tf=3.9e3``)
in float32 with the benchmark options, recording ``t`` and ``V``. D_sp, D_sn,
k_p and k_n are perturbed ±5% per cell from a numpy seed; cell 0 keeps the
published values. It runs on two routes (``ops/plan.py:Route``):

* path 1, ``PATH1``: the JAX package's default route — analytic assembly,
  no nested levels, group inverses in plain Gauss-Jordan, the 71×71 core
  through K1 (``gj_inverse``);
* path 2, ``PATH2``: the full-kernel route — analytic assembly, the nested
  j and Φ_s levels, the group inverses through K2 (``gj_blocks``) and the
  nested chain with the core inverse through K3 (``dchain``); K1 runs only
  in consistent initialization.

``COLORED`` is the colored-sweep route (``PETLION_JACA=0``), kept for
comparison. Two more paths go through the single-cell API and the stop
times, both on the default route:

* path 3, ``run_single``: ``simulate(p, I=-1, SOC=1)`` of one LCO cell with
  the model's own options (the golden flow), float64 by default;
* path 4, ``run_tstops``: path 1's batch with ``TSTOPS_OPTS`` (path 1's
  options with ``max_save`` 128, recording ``t`` and ``V``), three stop
  times per cell drawn from a numpy seed in [200, 3400] s (``tstops``) and
  the shared discontinuity ``TDISCON``.

Two more paths drive the control inputs, on the default route:

* path 5, ``run_gitt``: a batched GITT pulse — path 1's 1024 cells with
  ``GITT_OPTS`` (path 1's options, ``max_save`` 512, recording ``t``, ``V``
  and ``I``), each cell discharged at 1C by the function input
  ``gitt_current`` until its own ``t_pulse_off`` (θ, drawn from a numpy seed
  in [250, 650] s) and resting after it, with that time as the cell's
  ``tdiscon``, to ``GITT_TF`` = 900 s from SOC 1: the GITT sweep of the
  reference's examples/GITT.ipynb as one batch; each cell re-initializes
  at its own pulse end;
* path 6, ``run_cccv``: the CC→CV flow of one cell through ``simulate`` in
  float64 with the model's own options, ``simulate(p, I=2, SOC=0,
  V_max=4.1)`` then ``simulate_cont(sol, p, V="hold", I_min=0.05,
  SOC_max=1.0)``; ``run_power`` and ``run_eta`` are the 600 s ``P=-10`` and
  60 s ``eta_p=0.05`` runs from SOC 0.5 on the same model.

Path 7 is the JAX suite's SEI configuration (``bench_suite.py``
``4b_sei_discharge_batched``) at its published width:

* path 7, ``run_sei``: ``SEI_B`` = 256 NMC cells with SEI aging
  (``petlion(NMC, aging="SEI")``, 322 states on the default mesh, a
  92-state Newton core: j, Φ_e, Φ_s, film, SOH, j_s and I), float32 with
  ``SEI_OPTS`` (the benchmark options with ``max_save`` 128, recording
  ``t``, ``V`` and ``SOH``), a 1C discharge from SOC 1 (``I=-1``,
  ``tf=3.9e3``), D_sp, D_sn, k_p and k_n perturbed ±5% per cell from a
  seeded ``torch.Generator`` (cell 0 keeps the published values), on path
  1's route or, with ``route=PATH2``, the full-kernel route;
* ``run_sei_cycling``: the suite's ``4_sei_cycling``, one NMC+SEI cell
  through ``simulate``/``simulate_cont``: a charge at ``I=1`` from SOC 0.3
  to ``SOC_max=0.9`` (``V_max=4.25``), then three times a discharge at
  ``I=-1`` to ``SOC_min=0.3`` (``V_min=2.8``) and a charge back, with the
  suite's tolerances (abstol 5e-4, reltol 1e-3), recording ``t``, ``V`` and
  ``SOH``.

Three paths drive the thermal model and the protocols, each the JAX
suite's configuration (``bench_suite.py``) at its published width:

* path 8, ``run_protocol``: the suite's ``2_cc_cv_protocol`` —
  ``batch_protocol`` of ``B_MAIN`` isothermal LCO cells in float32 from SOC
  0 with path 1's options and θ sweep, ``CCCV_SEGMENTS`` (2C to V_max 4.1
  or SOC 1, then V held to SOC 1); K1 at (1024, 71, 71);
* path 9, ``run_thermal``: the suite's ``3_thermal_cc_ct_cv`` —
  ``simulate_protocol`` of one thermal LCO cell (``thermal_model``, 351
  states, a 121-state Newton core) through ``THERMAL_SEGMENTS`` (4C to
  T_max 313.15 K, the mean temperature held to V_max 4.1, then V held to
  SOC 1) from SOC 0 with max_save 256; in float32 with abstol 5e-4 and
  reltol 1e-3 (the refined pivoted LU, no TPU kernel), in float64 with the
  model's tolerances (K1 at (1, 121, 121) and the 71-state init block), on
  path 1's route or, with ``route=PATH2``, the full-kernel route;
* path 10, ``run_thermal_batched``: the suite's
  ``3b_thermal_discharge_batched`` — ``THERMAL_B`` = 128 thermal LCO cells
  in float32 with path 1's options and the first 128 cells of its θ sweep,
  a 1C discharge from SOC 1 in ``THERMAL_CHUNKS`` = 16 chunks of
  ``THERMAL_CHUNK_TF`` = 250 s, each chunk continuing from the last one's
  states and SOC (``batch_simulate(y_start=...)``); the refined pivoted LU.

Three paths drive the solver options, on path 1's model and θ sweep:

* path 11: path 1 with ``jac_reuse=REUSE_K`` (6, the K of the JAX package's
  test): each cell factors once per chunk of at most six steps (K1 at
  (1024, 71) on a trip on which some cell starts a chunk), the stale
  factor damped by cjratio (``solver/run.py``);
* path 12: path 1 with ``step_control="ida"`` (Sundials' step-growth
  hysteresis);
* path 13, the dense routes: (a) ``simulate(p, I=-1, SOC=1,
  fast_solver=False)`` of one float64 cell (``run_single``); the first
  ``DENSE_B`` = 64 cells of path 1's batch (b) through ``batch_simulate(...,
  fast_solver=False)`` (the dense Jacobian, one stacked pass over identity
  seeds, and the equilibrated pivoted LU), (c) through
  ``run_once(linear_solver=make_schur_solver(layout))`` (``run_solver``: the
  particle Schur complement of the dense matrix, its 101-state core through
  K1) and (d) through ``run_once(jac_plan=get_plan(..., use_schur=False))``
  (the colored dense matrix and the equilibrated pivoted LU). Each dense
  Jacobian pass has N·B = 19,264 rows at 64 cells (308k at 1024).

Path 14 is parameter estimation (``estimation.py``) in float64, the JAX
package's ``tests/test_estimation.py:18``:

* path 14, ``run_sensitivities``: ∂V/∂D_sp at ``SENS_T`` = 100, 300 and
  550 s of a 1C discharge of one LCO cell from SOC 0.5, one forward-mode
  run (a dual row) on path 1's route, K1 and its tangent K1ᵗ
  (``gj_tangent``) at n = 71; ``path14b`` the same on the full-kernel
  route (K2, K3 and their tangents: K1ᵗ at n = 10 and 30, K3ᵗ
  ``dchain_tangent``). The Gauss–Newton fit is ``chip_smoke.py``'s 14(c).
* ``path14m``: path 14's run with and without ``ops.dual.fast_zero_tangents``
  (PyTorch's own meta kernels of add and mul for the zero tangents) in
  turns, the walls alone (``light_meta_walls``).

``path10r`` is path 10's first chunk with ``jac_reuse=REUSE_K``, the case
the JAX package's configuration recommends reuse for (the float32 thermal
pivoted LU): profiled beside path 10's first chunk in one process.

``newton_matrices`` builds the Newton matrices of the main path that the
kernels see, and ``particle_schur_cores`` the 101-state cores of path 13(c),
for the tests and ``chip_smoke.py`` to hold the kernels on real inputs.
``chip_smoke.py`` checks these programs; run as a script,

    python -m petlion_tpu_torch.main_path [path1|...|path14|path14b|path14m|path10r ...]

profiles each named path (path 1 and path 2 by default) on the card: one
cold run, one warm run under ``torch.profiler`` (CPU and CUDA activities)
and three unprofiled warm runs of the same batch. It prints the warm walls,
the device time summed over all kernels, the kernels per outer trip, the
device-busy share of the wall, each hand-written kernel's launches and
share, and the kernels that take the most device time; for path 5 also the
outer trips, the trips that ran a re-initialization and their share of the
wall, and the control-function evaluations per trip; for the float32
thermal paths (path 9 is profiled in float32) the pivoted LU
factorizations; for every path the trips that factored the Newton matrix,
the factorizations per cell and the peak device memory. ``path10`` first
runs all ``THERMAL_CHUNKS`` chunks once and prints the attempts per cell
beside the JAX suite's TPU record, then profiles its first chunk;
``path13`` profiles its four runs one after another (path13a ... path13d).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import estimation
from .chemistry import LCO, NMC
from .ops import gj_kernel
from .ops.plan import FULL_KERNEL_ROUTE, Route, get_plan
from .ops.structured import make_schur_solver
from .parallel.batch import batch_simulate, cell_theta, cell_values
from .physics.initial_guess import initial_guess
from .protocols import batch_protocol, simulate_protocol
from .sim import Model, petlion, simulate, simulate_cont
from .solver import control, events, linsolve
from .solver import run as runner

B_MAIN = 1024
TF = 3.9e3
SWEPT_THETA = {"D_sp": 1e-14, "D_sn": 3.9e-14, "k_p": 2.334e-11, "k_n": 5.031e-11}
BENCH_OPTS = dict(abstol=5e-4, reltol=1e-3, max_save=2, maxiters=500)
WARM_RUNS = 3
TSTOPS_OPTS = dict(BENCH_OPTS, max_save=128, outputs=("t", "V"))
TDISCON = [1800.0]
GITT_OPTS = dict(BENCH_OPTS, max_save=512, outputs=("t", "V", "I"))
GITT_TF = 900.0
PATH1 = Route()
PATH2 = FULL_KERNEL_ROUTE
COLORED = Route(analytic=False)
PATHS = {"path1": PATH1, "path2": PATH2}
SEI_B = 256
SEI_OPTS = dict(BENCH_OPTS, max_save=128, outputs=("t", "V", "SOH"))
SEI_CYCLE_TOL = dict(abstol=5e-4, reltol=1e-3)
CCCV_SEGMENTS = [dict(I=2.0, V_max=4.1, SOC_max=1.0), dict(V="hold", SOC_max=1.0)]
THERMAL_SEGMENTS = [dict(I=4, V_max=4.1, T_max=313.15), dict(dT="hold", V_max=4.1),
                    dict(V="hold")]
THERMAL_F32_TOL = dict(abstol=5e-4, reltol=1e-3)
THERMAL_B = 128
THERMAL_CHUNKS = 16
THERMAL_CHUNK_TF = 250.0
REUSE_K = 6
REUSE_OPTS = dict(jac_reuse=REUSE_K)
IDA_OPTS = dict(step_control="ida")
DENSE_B = 64
SENS_T = (100.0, 300.0, 550.0)
KERNEL_SYMBOLS = {"gj_inverse": "gj_inverse_kernel",
                  "gj_blocks": "gj_blocks_kernel", "dchain": "dchain_kernel",
                  "gj_tangent": "gj_tangent_kernel",
                  "dchain_tangent": "dchain_tangent_kernel"}


def model(device="cuda") -> Model:
    """The float32 LCO model with the benchmark options."""
    p = petlion(LCO, device=device, dtype=torch.float32)
    p.opts = p.opts.replace(**BENCH_OPTS)
    return p


def theta_batch(seed: int) -> dict:
    """The swept θ of B_MAIN cells, ±5% from `seed`; cell 0 unperturbed."""
    rng = np.random.default_rng(seed)
    tb = {k: v * (1 + 0.05 * rng.standard_normal(B_MAIN))
          for k, v in SWEPT_THETA.items()}
    for k, v in SWEPT_THETA.items():
        tb[k][0] = v
    return tb


def run(p: Model, seed: int, route: Route = PATH1, n_cells: int = B_MAIN, **opts):
    """One batched discharge of the first `n_cells` cells on the card:
    (RunResultDev, wall seconds), the wall ending in a device
    synchronisation. `opts` go to ``batch_simulate`` (path 11's
    ``REUSE_OPTS``, path 12's ``IDA_OPTS``, path 13(b)'s
    ``fast_solver=False``)."""
    tb = {k: v[:n_cells] for k, v in theta_batch(seed).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch_simulate(p, TF, I=-1.0, SOC=1.0, theta_batch=tb,
                         outputs=("t", "V"), route=route, **opts)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run_solver(p: Model, seed: int, n_cells: int = DENSE_B, jac_plan=None,
               linear_solver=None):
    """Path 13(c, d): path 1's discharge of the first `n_cells` cells
    through ``run_once`` with `jac_plan` or `linear_solver` (the JAX
    package's only entry to the ``make_schur_solver`` route):
    (RunResultDev, wall seconds)."""
    kw = dict(dtype=p.dtype, device=p.device)
    tb = {k: v[:n_cells] for k, v in theta_batch(seed).items()}
    th = cell_theta(p, tb, None, kw)
    soc0 = cell_values(1.0, n_cells, kw)
    bounds = {k: cell_values(v, n_cells, kw)
              for k, v in events.bounds_dict(p.bounds).items()}

    def go():
        with torch.no_grad():
            return runner.run_once(
                y_start=initial_guess(soc0, th, p.cfg), soc0=soc0,
                value=cell_values(-1.0, n_cells, kw), tf=TF, th=th, bounds=bounds,
                cfg=p.cfg, spec=control.ControlSpec("I"),
                opts=p.opts.replace(outputs=("t", "V")), jac_plan=jac_plan,
                linear_solver=linear_solver)
    return _timed(go)



def _timed(fn):
    """(fn(), wall seconds), the wall ending in a device synchronisation."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_single(p: Model, **kwargs):
    """Path 3: one cell's 1C discharge from SOC 1 through ``simulate`` on
    the model's device: (Solution, wall seconds), the wall ending in a
    device synchronisation. `kwargs` go to ``simulate``."""
    return _timed(lambda: simulate(p, I=-1, SOC=1, **kwargs))


def tstops(seed: int, n_cells: int = B_MAIN):
    """Path 4's stop times: (n_cells, 3), sorted per cell, from `seed`."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(200.0, 3400.0, (n_cells, 3)), axis=1)


def run_tstops(p: Model, seed: int, n_cells: int = B_MAIN):
    """Path 4: path 1's batch with per-cell stop times and the shared
    discontinuity: (RunResultDev, wall seconds)."""
    tb = {k: v[:n_cells] for k, v in theta_batch(seed).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch_simulate(p, TF, I=-1.0, SOC=1.0, theta_batch=tb, route=PATH1,
                         tstops=tstops(seed, n_cells), tdiscon=TDISCON,
                         **TSTOPS_OPTS)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def t_pulse_off(seed: int, n_cells: int = B_MAIN):
    """Path 5's pulse ends, (n_cells,) in [250, 650] s, from `seed`."""
    return np.random.default_rng(seed).uniform(250.0, 650.0, n_cells)


def gitt_current(t, y, yp, th):
    """Path 5's input: −1C before the cell's own pulse end, 0 after it."""
    return torch.where(t < th["t_pulse_off"][:, 0], -torch.ones_like(t),
                       torch.zeros_like(t))


def run_gitt(p: Model, seed: int, n_cells: int = B_MAIN, current=gitt_current):
    """Path 5: (RunResultDev, wall seconds), the wall ending in a device
    synchronisation."""
    tb = {k: v[:n_cells] for k, v in theta_batch(seed).items()}
    t_off = t_pulse_off(seed, n_cells)
    tb["t_pulse_off"] = t_off
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch_simulate(p, GITT_TF, I=current, SOC=1.0, theta_batch=tb,
                         tdiscon=t_off[:, None], route=PATH1, **GITT_OPTS)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run_cccv(p: Model):
    """Path 6: the CC→CV pair on one cell, (Solution, wall seconds)."""
    def pair():
        sol = simulate(p, I=2, SOC=0, V_max=4.1)
        return simulate_cont(sol, p, V="hold", I_min=0.05, SOC_max=1.0)
    return _timed(pair)


def run_power(p: Model):
    """Path 6's constant-power run: 600 s at P = −10 W/m² from SOC 0.5."""
    return _timed(lambda: simulate(p, 600.0, P=-10.0, SOC=0.5))


def run_eta(p: Model):
    """Path 6's plating-overpotential run: 60 s at η_p = 0.05 V from SOC 0.5."""
    return _timed(lambda: simulate(p, 60.0, eta_p=0.05, SOC=0.5))


def sei_model(device="cuda", dtype=torch.float32) -> Model:
    """Path 7's NMC+SEI model with ``SEI_OPTS``."""
    p = petlion(NMC, aging="SEI", device=device, dtype=dtype)
    p.opts = p.opts.replace(**SEI_OPTS)
    return p


def sei_theta_batch(p: Model, seed: int, n_cells: int = SEI_B) -> dict:
    """Path 7's swept θ: D_sp, D_sn, k_p, k_n of `p` ±5% per cell from a
    seeded torch.Generator; cell 0 keeps the published values."""
    gen = torch.Generator().manual_seed(seed)
    tb = {}
    for k in SWEPT_THETA:
        x = 1 + 0.05 * torch.randn(n_cells, generator=gen, dtype=torch.float64)
        x[0] = 1.0
        tb[k] = (float(p.theta[k]) * x).numpy()
    return tb


def run_sei(p: Model, seed: int, route: Route = PATH1, n_cells: int = SEI_B):
    """Path 7: one batched 1C discharge of NMC+SEI cells on `p`'s device:
    (RunResultDev, wall seconds), the wall ending in a device
    synchronisation."""
    tb = sei_theta_batch(p, seed, n_cells)
    return _timed(lambda: batch_simulate(p, TF, I=-1.0, SOC=1.0, theta_batch=tb,
                                         route=route))


def run_sei_cycling(p: Model, cycles: int = 3):
    """The SEI cycling chain on one cell: (Solution, wall seconds)."""
    kw = dict(outputs=("t", "V", "SOH"), **SEI_CYCLE_TOL)

    def chain():
        s = simulate(p, I=1, SOC=0.3, SOC_max=0.9, V_max=4.25, **kw)
        for _ in range(cycles):
            s = simulate_cont(s, p, I=-1, SOC_min=0.3, V_min=2.8)
            s = simulate_cont(s, p, I=1, SOC_max=0.9, V_max=4.25)
        return s
    return _timed(chain)


def run_protocol(p: Model, seed: int, n_cells: int = B_MAIN):
    """Path 8: the CC-CV protocol of `n_cells` cells of path 1's θ sweep on
    `p` (path 1's model): (per-segment RunResultDev list, wall seconds)."""
    tb = {k: v[:n_cells] for k, v in theta_batch(seed).items()}
    return _timed(lambda: batch_protocol(p, CCCV_SEGMENTS, SOC=0.0, theta_batch=tb))


def thermal_model(device="cuda", dtype=torch.float32) -> Model:
    """Paths 9 and 10's thermal LCO model."""
    return petlion(LCO, temperature=True, device=device, dtype=dtype)


def run_thermal(p: Model, route: Route | None = None):
    """Path 9: the CC-CT-CV protocol of one thermal cell, (Solution, wall
    seconds); float32 at ``THERMAL_F32_TOL``, float64 at the model's
    tolerances."""
    tol = THERMAL_F32_TOL if p.dtype == torch.float32 else {}
    return _timed(lambda: simulate_protocol(p, THERMAL_SEGMENTS, SOC=0.0,
                                            max_save=256, route=route, **tol))


def run_thermal_batched(p: Model, seed: int, chunks: int = THERMAL_CHUNKS,
                        n_cells: int = THERMAL_B, **opts):
    """Path 10: `chunks` chunks of the thermal 1C discharge of `n_cells`
    cells, each from the last one's states and SOC: (list of RunResultDev,
    wall seconds). `opts` go to ``batch_simulate`` (path10r's
    ``REUSE_OPTS``)."""
    tb = {k: v[:n_cells] for k, v in theta_batch(seed).items()}

    def chain():
        out, y, soc = [], None, 1.0
        for _ in range(chunks):
            r = batch_simulate(p, THERMAL_CHUNK_TF, I=-1.0, SOC=soc, theta_batch=tb,
                               y_start=y, outputs=("t", "V"), **BENCH_OPTS, **opts)
            y, soc = r.y_final, r.soc_final.cpu().numpy()
            out.append(r)
        return out
    return _timed(chain)


def warm_walls(p: Model, seed: int, route: Route = PATH1, runs: int = WARM_RUNS,
               **opts):
    """`runs` runs of one batch in this process: the last run's result, the
    walls, their median and their relative spread (max − min) / median."""
    walls = []
    for _ in range(runs):
        res, wall = run(p, seed, route, **opts)
        walls.append(wall)
    med = statistics.median(walls)
    return res, walls, med, (max(walls) - min(walls)) / med


def _newton_inputs(n_states, seed, chemistry, hold_dT, options):
    """The model, its full-kernel plan, and `n_states` perturbed states with
    BDF coefficients c0 from 0.05 to 50 and the map g(y, data) whose
    Jacobian is the Newton matrix (float64, CPU)."""
    from .sim import _build_control
    kw = dict(dtype=torch.float64, device="cpu")
    p = petlion(chemistry, **kw, **options)
    plan = get_plan(p.cfg, p.theta_floats(), FULL_KERNEL_ROUTE)
    L = p.cfg.layout
    rng = np.random.default_rng(seed)
    th = {k: v.reshape(1, 1).expand(n_states, 1) for k, v in p.theta.items()}
    y = initial_guess(torch.as_tensor(rng.uniform(0.1, 1.0, n_states), **kw),
                      th, p.cfg).numpy()
    y *= 1.0 + 0.02 * rng.standard_normal(y.shape)
    for name, scale in (("j", 1e-6), ("Phi_e", 1e-2)):
        s = L.sl(name)
        y[:, s] = scale * rng.standard_normal((n_states, s.stop - s.start))
    if "T" in L:
        s = L.sl("T")
        y[:, s] = 3.0 + rng.standard_normal((n_states, s.stop - s.start))
    y[:, L.sl("I").start] = -1.0
    y = torch.as_tensor(y)
    c0 = torch.as_tensor(np.geomspace(0.05, 50.0, n_states), **kw)
    data = dict(th, _c0=c0[:, None],
                _const=torch.as_tensor(1e-3 * rng.standard_normal(y.shape)) - c0[:, None] * y)
    data["_v"] = torch.full((n_states, 1), 0.0 if hold_dT else -1.0, **kw)
    spec = (_build_control(p, None, {"dT": "hold"})[1] if hold_dT
            else control.ControlSpec("I"))

    def g(yy, d):
        return control.full_residual(spec, d["_v"][:, 0], 0.0, yy,
                                     d["_c0"] * yy + d["_const"], d, p.cfg)
    return p, plan, y, c0, th, data, g


def newton_matrices(n_states: int = 8, seed: int = 0, chemistry=LCO,
                    hold_dT: bool = False, **options):
    """Newton matrices of the main path (float64, CPU) at perturbed states
    with BDF coefficients c0 from 0.05 to 50, as the factorization sees
    them: (core, permuted, sizes, groups) — the Schur core after the group
    eliminations (n_states, 71, 71), the same permuted so that the nested
    levels lead, the level sizes, and the equilibrated particle and c_e
    group blocks. `chemistry` and `options` pick another model (path 7's:
    ``chemistry=NMC, aging="SEI"``, a 92-state core; path 9's:
    ``temperature=True``, a 121-state core, with T offsets of a few K), and
    `hold_dT` the control row of path 9's CT segment (the mean temperature
    held), which makes the core nearly singular."""
    from .ops import structured as st
    p, plan, y, c0, th, data, g = _newton_inputs(n_states, seed, chemistry, hold_dT,
                                                 options)
    JS, last = (plan.analytic.compressed(None, y, c0, th, g, data)
                if plan.analytic is not None else plan.colored.compressed(g, y, data))
    ds = plan.device_specs(y)
    _, D = st.eliminate_groups(JS, last, plan.colored, ds)
    groups = [linsolve._equilibrate(st._extract_A(JS, gt))[0] for gt in ds.groups]
    return D, st.permuted_core(D, ds), ds.sizes, groups


def particle_schur_cores(n_states: int = 8, seed: int = 0):
    """The particle Schur complements D − C A⁻¹ B of dense LCO Newton
    matrices at `newton_matrices`' states (float64, CPU): the 101-state
    cores that path 13(c) inverts through K1, (n_states, 101, 101)."""
    from .ops import structured as st
    p, plan, y, _, _, data, g = _newton_inputs(n_states, seed, LCO, False, {})
    J = plan.colored(g, y, data)
    return st.particle_schur_complement(J, st.make_split(p.layout))[-1]


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _path_run(name: str, p: Model, seed: int):
    """One run of a named path: (steps, rejected attempts) per cell as
    numpy arrays, and the wall."""
    if name in ("path8", "path10", "path10r"):
        if name == "path8":
            results, wall = run_protocol(p, seed)
        else:
            results, wall = run_thermal_batched(
                p, seed, chunks=1, **(REUSE_OPTS if name == "path10r" else {}))
        return (sum(r.n_steps for r in results).cpu().numpy(),
                sum(r.n_rejected for r in results).cpu().numpy(), wall)
    if name == "path9":
        sol, wall = run_thermal(p)
        return (np.array([sum(r.n_steps for r in sol.results)]),
                np.array([sum(r.n_rejected for r in sol.results)]), wall)
    if name == "path7":
        res, wall = run_sei(p, seed)
        return res.n_steps.cpu().numpy(), res.n_rejected.cpu().numpy(), wall
    if name in ("path3", "path6", "path13a"):
        sol, wall = (run_cccv(p) if name == "path6"
                     else run_single(p, fast_solver=name == "path3"))
        return (np.array([sum(r.n_steps for r in sol.results)]),
                np.array([sum(r.n_rejected for r in sol.results)]), wall)
    if name in ("path14", "path14b"):
        res, wall = run_sensitivities(p, route=PATH2 if name == "path14b" else PATH1)
        return res.n_steps.cpu().numpy(), res.n_rejected.cpu().numpy(), wall
    if name == "path5":
        res, wall = run_gitt(p, seed, current=_counted_current)
    elif name == "path4":
        res, wall = run_tstops(p, seed)
    elif name in ("path11", "path12"):
        res, wall = run(p, seed, **(REUSE_OPTS if name == "path11" else IDA_OPTS))
    elif name == "path13b":
        res, wall = run(p, seed, n_cells=DENSE_B, fast_solver=False)
    elif name == "path13c":
        res, wall = run_solver(p, seed, linear_solver=make_schur_solver(p.layout))
    elif name == "path13d":
        res, wall = run_solver(p, seed, jac_plan=get_plan(p.cfg, p.theta_floats(),
                                                          use_schur=False))
    else:
        res, wall = run(p, seed, route=PATHS[name])
    return res.n_steps.cpu().numpy(), res.n_rejected.cpu().numpy(), wall


def run_sensitivities(p: Model, route: Route = PATH1):
    """Path 14: ∂V/∂D_sp at SENS_T from SOC 0.5 at 1C by one forward-mode
    run; (the run's RunResultDev, wall ending in a synchronization)."""
    voltage, th0 = estimation.make_voltage_model(p, ["D_sp"], t_eval=SENS_T,
                                                 I_crate=-1.0, SOC=0.5, route=route)
    start = time.perf_counter()
    res = estimation.value_and_jacobian(voltage, th0)[2]
    if res.flag.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - start


CURRENT_CALLS = [0]


def _counted_current(t, y, yp, th):
    CURRENT_CALLS[0] += 1
    return gitt_current(t, y, yp, th)


def profile(p: Model, name: str, card: str):
    """Profile one path (see the module docstring) and print its numbers."""
    _path_run(name, p, seed=0)
    gj_kernel.reset_launch_counts()
    runner.reset_trip_counts()
    linsolve.LU_FACTORS[0] = 0
    CURRENT_CALLS[0] = 0
    torch.cuda.reset_peak_memory_stats()
    from torch.profiler import ProfilerActivity, profile as tprofile
    # a forward-mode trip dispatches ~44,000 host ops: recorded with CPU
    # activity, path 14's profiled run did not end in 15 minutes, so its
    # profile records the kernels alone
    activities = ([ProfilerActivity.CUDA] if name.startswith("path14")
                  else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with tprofile(activities=activities) as prof:
        steps, rejected, wall = _path_run(name, p, seed=1)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(gj_kernel.LAUNCHES)
    by_n = {k: dict(sorted(v.items())) for k, v in gj_kernel.LAUNCHES_BY_N.items()}
    lu = linsolve.LU_FACTORS[0]
    trips = dict(runner.TRIPS, cell_factors=list(runner.TRIPS["cell_factors"]))
    calls = CURRENT_CALLS[0]
    walls = [_path_run(name, p, seed=1)[2] for _ in range(WARM_RUNS)]
    med = statistics.median(walls)
    spread = (max(walls) - min(walls)) / med

    ka = prof.key_averages()
    # device-side entries only (a CPU op's entry repeats its kernels' time)
    kernels = [e for e in ka if str(getattr(e, "device_type", "")).endswith("CUDA")
               and _device_us(e) > 0]
    total_s = sum(_device_us(e) for e in kernels) / 1e6
    n_kernels = sum(e.count for e in kernels)
    att = steps + rejected
    n_trips = max(trips["trips"], 1)
    print(f"== {name}: {PATHS.get(name, Route.from_env())}, {len(steps)} cells, "
          f"{p.dtype} [{card}]")
    print(f"warm walls {', '.join(f'{w:.3f}' for w in walls)} s "
          f"unprofiled (median {med:.3f} s, spread {spread:.1%}), {wall:.3f} s "
          f"profiled; steps/cell mean {steps.mean():.2f}, "
          f"attempts/cell mean {att.mean():.2f} max {att.max()}")
    print(f"device kernel time {total_s:.3f} s over {n_kernels} kernel launches "
          f"({n_kernels / n_trips:.0f} per outer trip, {trips['trips']} trips); device busy "
          f"{total_s / med:.1%} of the unprofiled median wall, "
          f"{total_s / wall:.1%} of the profiled wall")
    if name == "path5":
        print(f"re-initializations: {trips['reinit']} of {trips['trips']} trips, "
              f"{trips['reinit_s']:.3f} s of host wall in them ({trips['reinit_s'] / wall:.1%} "
              f"of the profiled wall); {calls} calls of the input function, "
              f"{calls / n_trips:.1f} per trip")
    for kname, symbol in KERNEL_SYMBOLS.items():
        k_s = sum(_device_us(e) for e in kernels if symbol in e.key) / 1e6
        print(f"{kname} kernel: {launches[kname]} launches (by n {by_n[kname]}), "
              f"{k_s * 1e3:.2f} ms ({k_s / max(total_s, 1e-12):.2%} of device kernel time)")
    print(f"pivoted LU factorizations: {lu} ({lu / n_trips:.1f} per trip)")
    per_cell = sum(c.cpu().numpy() for c in trips["cell_factors"])
    print(f"Newton-matrix factorizations: {trips['factor_trips']} of {trips['trips']} "
          f"trips factored; per cell mean {per_cell.mean():.2f} max {per_cell.max()} "
          f"(attempts/cell mean {att.mean():.2f}); peak device memory "
          f"{peak / 2**20:.1f} MiB")
    sort_key = ("self_device_time_total"
                if hasattr(kernels[0] if kernels else ka[0], "self_device_time_total")
                else "self_cuda_time_total")
    print(ka.table(sort_by=sort_key, row_limit=25))


def main(names=("path1", "path2")):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    p32, p64 = model(), petlion(LCO)
    for name in names:
        if name == "path13":
            for part in "abcd":
                profile(p64 if part == "a" else p32, "path13" + part, card)
            continue
        p = (sei_model() if name == "path7"
             else thermal_model() if name in ("path9", "path10", "path10r")
             else p64 if name in ("path3", "path6", "path13a", "path14", "path14b")
             else p32)
        if name == "path10":
            chunks_all(p, card)
        if name == "path10r":
            reuse_chunk(p, card)
        if name == "path14m":
            light_meta_walls(p64, card)
            continue
        profile(p, name, card)


def chunks_all(p: Model, card: str):
    """Path 10 in full: all THERMAL_CHUNKS chunks once, the attempts per
    cell beside the JAX suite's TPU record (a count, not a target)."""
    linsolve.LU_FACTORS[0] = 0
    runner.reset_trip_counts()
    results, wall = run_thermal_batched(p, seed=0)
    att = sum((r.n_steps + r.n_rejected) for r in results).cpu().numpy()
    flags = np.stack([r.flag.cpu().numpy() for r in results])
    done = np.isin(flags, (1, 3)).any(axis=0)
    print(f"== path10 in full: {THERMAL_CHUNKS} chunks of {THERMAL_CHUNK_TF:g} s, "
          f"{len(att)} cells, {wall:.3f} s [{card}]; attempts/cell mean {att.mean():.1f} "
          f"(the JAX suite's TPU record 4232.2) max {att.max()}; cells that exited at "
          f"V_min or SOC_min {done.mean():.1%}; {runner.TRIPS['trips']} trips, "
          f"{linsolve.LU_FACTORS[0]} pivoted LU factorizations")


def reuse_chunk(p: Model, card: str):
    """Path 10's first chunk without and with ``jac_reuse=REUSE_K`` in
    turns (without, with, with, without, after one cold run of each): the
    walls, pivoted LU factorizations, attempts per cell, trips and the
    trips that factored."""
    for opts in ({}, REUSE_OPTS):
        run_thermal_batched(p, seed=0, chunks=1, **opts)
    for opts in ({}, REUSE_OPTS, REUSE_OPTS, {}):
        linsolve.LU_FACTORS[0] = 0
        runner.reset_trip_counts()
        results, wall = run_thermal_batched(p, seed=1, chunks=1, **opts)
        r = results[0]
        att = (r.n_steps + r.n_rejected).cpu().numpy()
        print(f"== path10{'r' if opts else ''} chunk 1, jac_reuse={opts.get('jac_reuse', 0)}: "
              f"{wall:.3f} s warm [{card}]; {linsolve.LU_FACTORS[0]} pivoted LU "
              f"factorizations, attempts/cell mean {att.mean():.2f} max {att.max()}, "
              f"{runner.TRIPS['trips']} trips, {runner.TRIPS['factor_trips']} factored")


def light_meta_walls(p: Model, card: str):
    """Path 14's run with and without ``fast_zero_tangents`` in turns (with,
    without, without, with, after one cold run of each): the walls, trips
    and ∂V/∂D_sp of each; the Jacobians must agree bit for bit."""
    light = estimation.fast_zero_tangents
    Js = []
    try:
        for i, on in enumerate((True, False, True, False, False, True)):
            estimation.fast_zero_tangents = light if on else contextlib.nullcontext
            runner.reset_trip_counts()
            voltage, th0 = estimation.make_voltage_model(p, ["D_sp"], t_eval=SENS_T,
                                                         I_crate=-1.0, SOC=0.5, route=PATH1)
            start = time.perf_counter()
            J = estimation.value_and_jacobian(voltage, th0)[1].cpu()
            wall = time.perf_counter() - start
            Js.append(J)
            print(f"== path14m {'cold' if i < 2 else 'warm'}, light meta kernels "
                  f"{'on' if on else 'off'}: {wall:.3f} s, {runner.TRIPS['trips']} trips "
                  f"[{card}]; dV/dD_sp {J[:, 0].tolist()}")
    finally:
        estimation.fast_zero_tangents = light
    if not all(torch.equal(J, Js[0]) for J in Js):
        raise SystemExit("path14m: the Jacobians differ with and without the light meta")


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("path1", "path2"))
