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

``newton_matrices`` builds the Newton matrices of the main path that the
kernels see, for the tests and ``chip_smoke.py`` to hold the kernels on real
inputs.
``chip_smoke.py`` checks these programs; run as a script,

    python -m petlion_tpu_torch.main_path [path1|path2|path3|path4 ...]

profiles each named path (path 1 and path 2 by default) on the card: one
cold run, one warm run under ``torch.profiler`` (CPU and CUDA activities)
and three unprofiled warm runs of the same batch. It prints the warm walls,
the device time summed over all kernels, the kernels per outer trip, the
device-busy share of the wall, each hand-written kernel's launches and
share, and the kernels that take the most device time.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .chemistry import LCO
from .ops import gj_kernel
from .ops.plan import FULL_KERNEL_ROUTE, Route
from .parallel.batch import batch_simulate
from .sim import Model, petlion, simulate

B_MAIN = 1024
TF = 3.9e3
SWEPT_THETA = {"D_sp": 1e-14, "D_sn": 3.9e-14, "k_p": 2.334e-11, "k_n": 5.031e-11}
BENCH_OPTS = dict(abstol=5e-4, reltol=1e-3, max_save=2, maxiters=500)
WARM_RUNS = 3
TSTOPS_OPTS = dict(BENCH_OPTS, max_save=128, outputs=("t", "V"))
TDISCON = [1800.0]
PATH1 = Route()
PATH2 = FULL_KERNEL_ROUTE
COLORED = Route(analytic=False)
PATHS = {"path1": PATH1, "path2": PATH2}
KERNEL_SYMBOLS = {"gj_inverse": "gj_inverse_kernel",
                  "gj_blocks": "gj_blocks_kernel", "dchain": "dchain_kernel"}


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


def run(p: Model, seed: int, route: Route = PATH1, n_cells: int = B_MAIN):
    """One batched discharge of the first `n_cells` cells on the card:
    (RunResultDev, wall seconds), the wall ending in a device
    synchronisation."""
    tb = {k: v[:n_cells] for k, v in theta_batch(seed).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch_simulate(p, TF, I=-1.0, SOC=1.0, theta_batch=tb,
                         outputs=("t", "V"), route=route)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run_single(p: Model, **kwargs):
    """Path 3: one cell's 1C discharge from SOC 1 through ``simulate`` on
    the model's device: (Solution, wall seconds), the wall ending in a
    device synchronisation. `kwargs` go to ``simulate``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = simulate(p, I=-1, SOC=1, **kwargs)
    torch.cuda.synchronize()
    return sol, time.perf_counter() - t0


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


def warm_walls(p: Model, seed: int, route: Route = PATH1):
    """WARM_RUNS runs of one batch in this process: the last run's result,
    the walls, their median and their relative spread (max − min) / median."""
    walls = []
    for _ in range(WARM_RUNS):
        res, wall = run(p, seed, route)
        walls.append(wall)
    med = statistics.median(walls)
    return res, walls, med, (max(walls) - min(walls)) / med


def newton_matrices(n_states: int = 8, seed: int = 0):
    """Newton matrices of the main path (float64, CPU) at perturbed states
    with BDF coefficients c0 from 0.05 to 50, as the factorization sees
    them: (core, permuted, sizes, groups) — the Schur core after the group
    eliminations (n_states, 71, 71), the same permuted so that the nested
    levels lead, the level sizes, and the equilibrated particle and c_e
    group blocks."""
    from .ops import structured as st
    from .ops.plan import get_plan
    from .physics.initial_guess import initial_guess
    from .solver import control, linsolve
    kw = dict(dtype=torch.float64, device="cpu")
    p = petlion(LCO, **kw)
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
    y[:, L.sl("I").start] = -1.0
    y = torch.as_tensor(y)
    c0 = torch.as_tensor(np.geomspace(0.05, 50.0, n_states), **kw)
    data = dict(th, _c0=c0[:, None],
                _const=torch.as_tensor(1e-3 * rng.standard_normal(y.shape)) - c0[:, None] * y)
    spec = control.ControlSpec("I")
    value = torch.full((n_states,), -1.0, **kw)

    def g(yy, d):
        return control.full_residual(spec, value, 0.0, yy,
                                     d["_c0"] * yy + d["_const"], d, p.cfg)

    JS, last = plan.analytic.compressed(None, y, c0, th, g, data)
    ds = plan.device_specs(y)
    _, D = st.eliminate_groups(JS, last, plan.colored, ds)
    groups = [linsolve._equilibrate(st._extract_A(JS, gt))[0] for gt in ds.groups]
    return D, st.permuted_core(D, ds), ds.sizes, groups


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _path_run(name: str, p: Model, seed: int):
    """One run of a named path: (steps, rejected attempts) per cell as
    numpy arrays, and the wall."""
    if name == "path3":
        sol, wall = run_single(p)
        r = sol.results[-1]
        return np.array([r.n_steps]), np.array([r.n_rejected]), wall
    res, wall = (run_tstops(p, seed) if name == "path4"
                 else run(p, seed, route=PATHS[name]))
    return res.n_steps.cpu().numpy(), res.n_rejected.cpu().numpy(), wall


def profile(p: Model, name: str, card: str):
    """Profile one path (see the module docstring) and print its numbers."""
    _path_run(name, p, seed=0)
    gj_kernel.reset_launch_counts()
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps, rejected, wall = _path_run(name, p, seed=1)
    launches = dict(gj_kernel.LAUNCHES)
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
    trips = max(int(att.max()), 1)
    print(f"== {name}: {PATHS.get(name, Route.from_env())}, {len(steps)} cells, "
          f"{p.dtype} [{card}]")
    print(f"warm walls {', '.join(f'{w:.3f}' for w in walls)} s "
          f"unprofiled (median {med:.3f} s, spread {spread:.1%}), {wall:.3f} s "
          f"profiled; steps/cell mean {steps.mean():.2f}, "
          f"attempts/cell mean {att.mean():.2f} max {att.max()}")
    print(f"device kernel time {total_s:.3f} s over {n_kernels} kernel launches "
          f"({n_kernels / trips:.0f} per outer trip); device busy "
          f"{total_s / med:.1%} of the unprofiled median wall, "
          f"{total_s / wall:.1%} of the profiled wall")
    for kname, symbol in KERNEL_SYMBOLS.items():
        k_s = sum(_device_us(e) for e in kernels if symbol in e.key) / 1e6
        print(f"{kname} kernel: {launches[kname]} launches, {k_s * 1e3:.2f} ms "
              f"({k_s / max(total_s, 1e-12):.2%} of device kernel time)")
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
        profile(p64 if name == "path3" else p32, name, card)


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("path1", "path2"))
