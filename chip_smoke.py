#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
`ok` line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 set off and asserted off, and the port must refuse a
   float32 CUDA run while matmul TF32 is on;
2. build: compile the five kernels (petlion_tpu_torch/csrc/gj_inverse.cu,
   gj_blocks.cu, dchain.cu and the tangents gj_tangent.cu, dchain_tangent.cu)
   from the checkout, one nvcc per source, all started together;
3. kernels, each held against its plain PyTorch version on the card and
   timed beside its bound, the plain version and, where one PyTorch call
   computes the same function, that call (a yardstick the port never calls):
   K1 gj_inverse at (B, n) = (1024, 71), (5, 71), (8, 37), (3, 17) in float32
   (max |Δ| ≤ 2e-4 against the plain blocked version and against its mirror
   gj_inverse_inplace, ‖AX − I‖∞ < 1e-3) and (64, 71) in float64 (≤ 1e-10);
   every n from 1 to 169 in float32 and 1 to 120 in float64 against the
   mirror; and the equilibrated 71×71 Schur cores of real Newton matrices
   (8 states tiled to 1024): the float32 error against float64, relative to
   each matrix's scale, at most 4× that of the plain float32 mirror and of
   the blocked version at the TPU kernel's block width 8, plus 1e-5;
   K2 gj_blocks at (M, n) = (10240, 10), (1024, 30) and the odd sizes
   (7, 10), (7, 17), (7, 30) in float32 (max |Δ| ≤ 2e-4 against the plain
   version and against its mirror gj_blocks_mirror, ‖AX − I‖∞ < 1e-3) and
   (10240, 10), (1024, 30) in float64 (≤ 1e-10), random diagonally dominant
   matrices, equilibrated; every n from 1 to 32 in float32 and float64
   against the mirror and the plain version; then the particle and c_e
   blocks of real Newton matrices (float32 error against float64 at most 4×
   the plain float32 version's plus 1e-5);
   K3 dchain on permuted Schur cores of real Newton matrices of the main
   path (8 states, tiled to 1024 cells, and 5 cells) with level sizes
   (20, 20): in float32 every output must be as close to the float64 chain
   as the plain float32 chain is (error relative to the output's scale at
   most 4× the plain version's plus 1e-5), and in float64 kernel and plain
   version agree within 1e-8 of each output's scale (the Φ_s level is
   nearly singular before the j fill lands on it, so rounding is amplified
   some 1e5-fold: the plain float32 chain is 5.7e-3 off float64 there);
   then diagonally dominant cores at other level sizes, some with levels
   above 32 (the 16×16 tile grid), against the plain chain.
   K1 and K3 are timed over four rotating input buffers (82 MB in all, more
   than the 50 MB L2), K2 and torch.linalg.inv_ex at K2's two main-path
   shapes over sixteen (60-66 MB), behind a spin kernel that holds the
   stream while the host queues the launches, so the time is the device's;
   the host µs per wrapper call are printed beside it;
   the tangent kernels of path 14 (phase_k1t, phase_k3t): K1ᵗ (dX =
   −X·dA·X) at (1, 71), (2, 71), (10, 10) and (1, 30) in float64 (path
   14's shapes), (1024, 71) in float32, (10240, 10) and (1024, 30) in
   float32 and float64; K3ᵗ on the permuted real cores K3 takes (B = 1, 5,
   1024) in float32 and float64; each held against its plain version
   (float64 within 1e-10 of the tangent's scale; float32 error against
   float64 at most 4× the plain float32 version's plus 1e-5) and timed
   beside its first design's time, its bound, the plain version and two
   torch.bmm calls, with the host µs a call, the launch plan (held to the
   compiled source's) and the registers and spills of every kernel
   instance. From here until path 14 every reset of the launch counts
   checks that no tangent kernel launched;
4. main paths (petlion_tpu_torch/main_path.py): `batch_simulate` of 1024 LCO
   cells, a 1C discharge from SOC 1 in float32 with the benchmark options,
   D_sp/D_sn/k_p/k_n perturbed ±5% per cell from a numpy seed (cell 0
   unperturbed), on path 1 (analytic assembly, K1 for the core) and path 2
   (the full-kernel route: nested levels, K2 group inverses, K3 chain).
   Each path is driven with the launch counts set to 0 just before and read
   just after. Every cell must exit with flag 0, 1 or 3, each kernel of the
   path must have been launched, and cell 0 must land within 5 s and 8e-3 V
   of the float64 oracle (tests/data/oracle_lco_1c.npz). Then a warm run
   of one batch per path (EARLY_WARM runs, one: the script's time limit;
   `python -m petlion_tpu_torch.main_path` takes three) gives
   discharges/s; the later paths take no warm run (to leave room for
   path 14 in the time limit; main_path.py takes their walls). The colored-sweep route
   (PETLION_JACA=0) is driven once at 64 cells under the same checks.
5. simulate (path 3, `main_path.run_single`): the golden single-cell flow
   on the card in float64 on the default route (K1 for the 71x71 core):
   `simulate(p, I=-1, SOC=1)` must exit "Below min. SOC" within 5 s of
   3600 s and 8e-3 V of the golden 2.9357 V and of the oracle; then
   `simulate_cont(sol, p, 600.0, I="rest")` must reach tf with two runs;
   `sol(t)` must go through the native C++ spline; the solution is saved,
   loaded and resumed; the float32 discharge (abstol 1e-3) must stay within
   5 mV of the float64 trace, each read through its Solution's
   interpolation. K1 must be launched in the phase (no warm run: the
   script's time limit; main_path.py path3 takes the walls).
6. tstops (path 4, `main_path.run_tstops`): path 1's 1024 cells in float32
   with max_save 128, three stop times per cell from a numpy seed in
   [200, 3400] s and a shared discontinuity at 1800 s: every cell must exit
   with flag 3 and record a time within 1e-2 s of each of its stops and of
   1800 − reltol/2, cell 0 within 5 s and 8e-3 V of the oracle; steps and
   attempts per cell are printed beside path 1's.

7. gitt (path 5, `main_path.run_gitt`): 1024 LCO cells in float32 on the
   default route, each discharged at 1C by a batch-first function input
   until its own pulse end (θ `t_pulse_off`, a numpy seed, 250-650 s) and
   resting to 900 s, with that time as the cell's tdiscon, so that each
   cell re-initializes at its own jump: every cell must exit with flag 0,
   record a time within 1e-2 s of its pulse end, carry |I + 1| < 1e-3
   before it (up to 0.01 s) and |I| < 1e-3 after it (from 0.5 s), and end
   within 1 s of 900 s; K1 must be launched, and the trips that ran a
   re-initialization are printed.
8. cccv (path 6, `main_path.run_cccv`, `run_power`, `run_eta`): one cell
   in float64 through `simulate`, 2C from SOC 0 to V_max 4.1 V ("Above max.
   voltage"), then V = "hold" until I_min 0.05C ("Below min. C-rate" with
   |I - 0.05| < 5e-3, or "Above max. SOC") with the power continuous across
   the boundary (rtol 1e-3); then P = -10 W/m² for 600 s (|P + 10| < 1e-6)
   and eta_p = 0.05 V for 60 s (|eta_p - 0.05| < 1e-6) from SOC 0.5. K1 must
   be launched.

9. k1_core92 (after the K1 phase): K1 at the cores of path 7 (NMC + SEI,
   92 states) and of the stress model (91) in float32, at (256, n): random
   equilibrated matrices against the plain version, the mirror (≤ 2e-4)
   and a float64 inverse (≤ 1e-5 of the scale); the real equilibrated
   cores (8 states tiled to 256) in float32 as close to float64 as the
   plain versions (4× plus 1e-5), in float64 against the mirror (≤ 1e-8);
   the time at (256, 92) over eight rotating inputs behind the spin, beside
   its bound, the plain version and torch.linalg.inv_ex, and the registers
   and spills of the tile instance it takes (T = 16, P = 8) from ptxas.
10. sei (path 7, `main_path.run_sei`): 256 NMC cells with SEI aging in
   float32, a 1C discharge from SOC 1, θ perturbed from a torch.Generator
   seed, on the default route (K1 must launch at n = 92) and on the
   full-kernel route (K2 and K3, K3 at n = 92): every cell exits with flag
   0, 1 or 3, its recorded SOH never rises (1e-12), its film stays ≥ 0; the
   two routes agree in V within 1e-4 V on the saved points where they step
   in lockstep and at the exit, and in exit time within 1e-4 (relative);
   cell 0 lies within 2 mV of the same cell in float64 on the card (read
   through that run's interpolation, up to 100 s before the exit).
11. sei_cycling (`main_path.run_sei_cycling`): the JAX suite's
   4_sei_cycling on one cell in float32 and in float64 — the exit sequence
   "Above max. SOC", then "Below min. SOC" / "Above max. SOC" once (one
   cycle of the suite's three: the script's time limit), SOH
   never rising over the chain, the final SOH of the two within 1e-5
   (relative); K1 must launch.
12. variants: one float64 cell, 600 s of a 1C discharge, of
   NMC_LGM50(aging="stress"), LCO(solid_diffusion="polynomial"),
   LCO(Fickian_method="spectral") and LCO(anode="Li_metal"), on the card
   and on the CPU in this process: the same exit, steps and rejections, V
   within 1e-9, K1 launched on the card; then two half cells on the
   full-kernel route (K2 on the cathode particles and the c_e group, none
   for the absent anode; K3), card = CPU within 1e-9.
13. k1_core101 (after k1_core121): K1 at the 101-state particle-Schur core
   of path 13(c) in float32 at (1024, 101): random matrices against the
   plain version, the mirror and a float64 inverse; a subset inverted alone
   equal bit for bit to the same rows of the batch's inverse; the real
   cores (8 states tiled to 1024) as accurate as the plain versions; times
   at (1024, 101) and (64, 101); the T = 16, P = 8 tile's registers and
   spills.
14. solver options (after paths 8-10): path 11, path 1 with jac_reuse=6,
   and path 12, path 1 with step_control="ida", under path 1's checks, with
   factorizations, attempts and rejections per cell beside path 1's.
15. dense routes (path 13), one cold run each: the golden discharge of one
   float64 cell with fast_solver=False against path 3's fast route (rtol
   1e-10 on t, 1e-8 on V), and 64 float32 cells of path 1 through
   batch_simulate(fast_solver=False), run_once(linear_solver=
   make_schur_solver(layout)) (K1 at n = 101) and run_once(jac_plan=
   get_plan(..., use_schur=False)), under path 1's checks, with the peak
   device memory of each.
16. the last modules (path 15: (a)-(c) in a child process of this script,
   `--path15`, and (d) in subprocesses, all started after path 13 when the
   tangent guard is lifted and run beside path 14 on other host cores, the
   script's time limit; the child checks that it launched no tangent
   kernel, prints its phase walls and its K1 launches, and any child
   failing fails the script): (a) path 1's 1024 float32 cells through
   batch_simulate(mesh=make_cell_mesh()) (every visible card, one shard
   each) under path 1's checks; then MESH_B = 64 float64 cells of path 1
   split over two shards of the one card (make_cell_mesh(devices=
   ["cuda:0", "cuda:0"]), a host thread each) against the same cells
   unsplit: the JAX test's tolerances (tests/test_batch.py:53-56: t_final
   rtol 1e-12, y_final rtol 1e-8) and the same flags; the split run's
   trips are its shards' slowest cells' attempts summed and its K1 launches
   each shard's initialization (as many as the unsplit run's) plus one a
   trip; (b) batch_cost_analysis (one trip after consistent
   initialization: flops, bytes accessed, aten ops, the kernels' launches by
   their ops/cost.py formulas) of paths 1 and 2 at 1024 float32 cells on
   the card, each trip's flops and bytes over the mean trip wall of path
   1's warm run (phase 4) against the card's peaks; at 64 cells the card's
   count on each route within 1% of the CPU's in the same process, the
   kernels' entries equal; (c) utils.profiling.trace around one 64-cell
   path 1 run (its Chrome trace must hold CUDA kernel events of K1's
   symbol) and a Timer around the same run with the result as sync (it
   must report one call); (d) the examples (petlion_tpu_torch/examples/)
   cc_cv, model_inputs_and_outputs, variable_input_functions and
   multichip_sweep (64 cells a card) as `python -m` subprocesses on the
   card (one host thread of torch each): each must exit 0 within
   EXAMPLE_TIMEOUT and print the line its JAX twin's test expects
   (EXAMPLES_ON_CARD); their walls are printed. getting_started, gitt and
   updating_parameters do not fit the time limit beside the rest, and
   fast_charging_cc_ct_cv and parameter_estimation drive the programs of
   paths 9 and 14(c): `python -m petlion_tpu_torch.examples` runs all nine
   one at a time with their walls.
17. estimation (path 14, float64, `petlion_tpu_torch.estimation`): (a)
   `sensitivities(p, ["D_sp"], [100, 300, 550], I_crate=-1, SOC=0.5)` (the
   JAX package's tests/test_estimation.py:18) on the default route, which
   must launch K1ᵗ at n = 71, held against the port's central difference on
   the card (ε = 1e-18, rtol 1e-5) and against the port on the CPU (rtol
   1e-8); (b) the same on the full-kernel
   route, which must launch K1ᵗ at n = 10 and 30 and K3ᵗ, within 1e-7 of
   (a); (c) the JAX test's Gauss–Newton recovery of {D_sp: 1.7e-14, k_n:
   3.1e-11} from (1e-14, 5.031e-11), 24 points on 60–1700 s from SOC 0.9,
   GN_ITERS = 5 iterations at most (the JAX test takes 10; the fit reaches
   rms ~3e-12 by its sixth: the script's time limit): each within 1e-3.
   Walls, trips, Gauss–Newton
   iterations and rms, and launches by kernel and n are printed.

The line before the last is the kernels' JSON record (one entry per kernel;
`launches` is the count of the paths that run it: path 1, simulate, tstops,
gitt, cccv, the protocol, paths 11-13 and path 15 in this process (at n =
71) for K1, path 2 for K2
and K3; `gj_inverse_n92`, `gj_inverse_n121_f64` and `gj_inverse_n101` are
K1 at the 92-state core of path 7, the thermal core of path 9 and the
particle-Schur core of path 13(c), each with the launches at that n;
`gj_tangent` and `dchain_tangent` are K1ᵗ and K3ᵗ, with their launches on
path 14 and, beside the record's keys, the two-torch.bmm yardstick
`bmm_ms`; they replace no TPU kernel of their own: their `replaces` names
the TPU kernel whose Pallas JVP they stand for); the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

T_START = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "tests", "data", "oracle_lco_1c.npz")

# spin that holds the stream while the host queues timed launches: 1.2e8
# cycles, at least 60 ms at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 120_000_000
ROTATING = 4        # input buffers rotated in the K1 and K3 timings (82 MB)
# warm runs of paths 1 and 2 (one, to keep the script inside its time limit;
# main_path.py profiles three a path)
EARLY_WARM = 1
K2_ROTATING = 16    # and in K2's (60-66 MB at either main-path shape)
MESH_B = 64         # path 15's float64 split, cost comparison and profile
# path 15(d): the examples run on the card at once, each with the line its
# JAX twin's test expects (multichip_sweep's count is set by the cards)
EXAMPLES_ON_CARD = {"cc_cv": "exit reasons:", "model_inputs_and_outputs": "run 1:",
                    "variable_input_functions": "feedback I:", "multichip_sweep": "completed"}
EXAMPLE_TIMEOUT = 600
PATH15_TIMEOUT = 900
GN_ITERS = 5        # path 14(c)'s Gauss-Newton iterations at most


class SmokeFailure(Exception):
    pass


_MARKS = [("start", T_START)]


def mark(name):
    """The end of a phase: phase_walls() reads the walls between marks."""
    _MARKS.append((name, time.time()))


def phase_walls():
    return [(b[0], b[1] - a[1]) for a, b in zip(_MARKS, _MARKS[1:])]


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_time_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, inputs, reps, spin=True):
    """(device ms per call of fn, host µs per call), rotating over `inputs`
    (so that the reads come from device memory when the inputs exceed the
    L2). With `spin`, a spin kernel holds the stream while the host queues
    the calls, so CUDA events time the queued calls alone (checked: the host
    must queue them faster than the spin lasts); without, as cuda_time_ms
    (for the plain versions, whose host work is part of what they cost).
    The host µs are the wall of the loop that queues the calls, per call."""
    import torch
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    if spin:
        check(host_ms < SPIN_CYCLES / 1.98e9 * 1e3,
              f"host took {host_ms:.2f} ms to queue {reps} calls, longer than the spin")
    return start.elapsed_time(stop) / reps, host_ms * 1e3 / reps


def waits_for_device(fn, x):
    """Whether one call of fn waits for the device on the host (a spin
    queued before it holds the call's return); such a call cannot be timed
    behind the spin."""
    import torch
    fn(x)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    fn(x)
    waited = time.perf_counter() - t0 > 0.5 * SPIN_CYCLES / 1.98e9
    torch.cuda.synchronize()
    return waited


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    # the elimination's float32 products must not round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 is on")
    check(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is on")
    # and the port refuses a float32 CUDA run while matmul TF32 is on
    import petlion_tpu_torch as ptt
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ptt.petlion(ptt.LCO, device="cuda", dtype=torch.float32)
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(refused, "the port accepted a float32 CUDA run with TF32 on")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from petlion_tpu_torch.ops import gj_kernel
    t0 = time.time()
    gj_kernel.compile_all()
    print(f"build: {time.time() - t0:.2f} s ({', '.join(gj_kernel.KERNEL_SOURCES)})")
    for name, log in gj_kernel.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())


def _equilibrated_inputs(B, n, dtype, seed):
    import numpy as np
    import torch
    from petlion_tpu_torch.solver.linsolve import _equilibrate
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + 20.0 * np.eye(n)
    A = torch.as_tensor(A, dtype=dtype, device="cuda")
    return _equilibrate(A)[0].contiguous()


def _k1_real_cores(D, reps):
    """K1 on the equilibrated real cores `D` tiled `reps` times: the float32
    errors against the float64 mirror, relative to each matrix's scale, of
    the kernel, the mirror and the blocked version at bs = 8 and at the
    plain version's width, and the float64 kernel's error."""
    import torch
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver.linsolve import _equilibrate
    As = _equilibrate(D.to("cuda"))[0].repeat(reps, 1, 1).contiguous()
    ref = gk.gj_inverse_inplace(As)
    scale = ref.abs().amax(dim=(-2, -1), keepdim=True)

    def rel(X):
        return float(((X.double() - ref).abs() / scale).max())

    n = As.shape[-1]
    return tuple(As.shape), dict(
        kernel=rel(gk.gj_inverse_cuda(As.float())),
        mirror=rel(gk.gj_inverse_inplace(As.float())),
        b8=rel(gk.gj_inverse_blocked(As.float(), bs=8)),
        best=rel(gk.gj_inverse_blocked(As.float(), bs=gk._best_bs(n))),
        scalar=rel(gk.gj_inverse_inplace(As.float(), bs=1)),
        f64=rel(gk.gj_inverse_cuda(As)))


def _k1_timing(B, n, rotating, seed):
    """K1's device ms and host µs per call at (B, n) float32 over `rotating`
    inputs behind the spin, the plain version's and torch.linalg.inv_ex's
    ms, and the bound: a dict of the record's timing keys."""
    import torch
    from petlion_tpu_torch.ops import cost, gj_kernel as gk
    bufs = [_equilibrated_inputs(B, n, torch.float32, seed=seed + i) for i in range(rotating)]
    ms, host_us = device_ms(gk.gj_inverse_cuda, bufs, reps=200)
    plain_ms, _ = device_ms(lambda A: gk.gj_inverse_blocked(A, bs=gk._best_bs(n)), bufs,
                            reps=8, spin=False)
    library_ms, _ = device_ms(lambda A: torch.linalg.inv_ex(A)[0], bufs, reps=8, spin=False)
    bound_ms, by = cost.bound(*reversed(cost.gj_inverse(B, n, 4)))
    print(f"kernel timing ({B}, {n}) f32, {rotating} rotating inputs: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.linalg.inv_ex {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of it reached); host "
          f"{host_us:.1f} us per gj_inverse_cuda call")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=by)


def phase_k1(D):
    import torch
    from petlion_tpu_torch.ops import gj_kernel as gk
    rows = {}
    for B, n in ((1024, 71), (5, 71), (8, 37), (3, 17)):
        A = _equilibrated_inputs(B, n, torch.float32, seed=B * 1000 + n)
        X = gk.gj_inverse_cuda(A)
        P = gk.gj_inverse_blocked(A, bs=gk._best_bs(n))
        mirror = gk.gj_inverse_inplace(A)
        torch.cuda.synchronize()
        err = float((X - P).abs().max())
        err_m = float((X - mirror).abs().max())
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        resid = float((A.double() @ X.double() - eye).abs().amax(dim=(-2, -1)).max())
        print(f"kernel f32 ({B}, {n}): max|kernel - plain| = {err:.3e}, "
              f"max|kernel - mirror| = {err_m:.3e}, max ||AX - I||inf = {resid:.3e}")
        check(err <= 2e-4, f"kernel disagrees with plain at ({B}, {n}): {err}")
        check(err_m <= 2e-4, f"kernel disagrees with its mirror at ({B}, {n}): {err_m}")
        check(resid < 1e-3, f"kernel inverse residual at ({B}, {n}): {resid}")
        rows[(B, n)] = err
    A64 = _equilibrated_inputs(64, 71, torch.float64, seed=64071)
    X64 = gk.gj_inverse_cuda(A64)
    err64 = float((X64 - gk.gj_inverse_blocked(A64, bs=gk._best_bs(71))).abs().max())
    err64_m = float((X64 - gk.gj_inverse_inplace(A64)).abs().max())
    print(f"kernel f64 (64, 71): max|kernel - plain| = {err64:.3e}, "
          f"max|kernel - mirror| = {err64_m:.3e}")
    check(err64 <= 1e-10 and err64_m <= 1e-10, "float64 kernel disagrees with plain")

    # every size the kernel takes, against the mirror
    for dtype, n_max, tol in ((torch.float32, 169, 2e-4), (torch.float64, 120, 1e-10)):
        worst = 0.0
        for n in range(1, n_max + 1):
            A = _equilibrated_inputs(3, n, dtype, seed=n)
            worst = max(worst, float((gk.gj_inverse_cuda(A) - gk.gj_inverse_inplace(A))
                                     .abs().max()))
        print(f"kernel {str(dtype)[6:]} n = 1..{n_max} (B = 3): "
              f"max|kernel - mirror| = {worst:.3e} (tol {tol:g})")
        check(worst <= tol, f"kernel disagrees with its mirror in {dtype}: {worst}")

    # the Schur cores of real Newton matrices (condition ~4e10)
    shape, e = _k1_real_cores(D, 128)
    print(f"K1 real cores {shape}: f32 error vs f64 / scale: kernel {e['kernel']:.3e}, "
          f"mirror {e['mirror']:.3e}, blocked bs=8 {e['b8']:.3e}, blocked "
          f"bs={gk._best_bs(71)} {e['best']:.3e}, scalar in-place {e['scalar']:.3e}; "
          f"f64 kernel vs mirror {e['f64']:.3e}")
    check(e["kernel"] <= 4 * e["mirror"] + 1e-5 and e["kernel"] <= 4 * e["b8"] + 1e-5,
          f"K1 less accurate than plain on real cores: {e['kernel']}")
    check(e["f64"] <= 1e-8, f"K1 float64 disagrees on real cores: {e['f64']}")
    return dict(max_abs_err=rows[(1024, 71)], **_k1_timing(1024, 71, ROTATING, seed=7))


def phase_k2(groups):
    import torch
    from petlion_tpu_torch.ops import cost, gj_blocks as kb
    cases = [((10240, 10), torch.float32, 2e-4), ((1024, 30), torch.float32, 2e-4),
             ((7, 10), torch.float32, 2e-4), ((7, 17), torch.float32, 2e-4),
             ((7, 30), torch.float32, 2e-4), ((10240, 10), torch.float64, 1e-10),
             ((1024, 30), torch.float64, 1e-10)]
    errs = {}
    for (M, n), dtype, tol in cases:
        A = _equilibrated_inputs(M, n, dtype, seed=M * 100 + n)
        X = kb.gj_blocks_cuda(A)
        P = kb.gj_blocks_plain(A)
        mirror = kb.gj_blocks_mirror(A)
        torch.cuda.synchronize()
        err = float((X - P).abs().max())
        err_m = float((X - mirror).abs().max())
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        resid = float((A.double() @ X.double() - eye).abs().amax(dim=(-2, -1)).max())
        print(f"K2 {str(dtype)[6:]} ({M}, {n}, {n}): max|kernel - plain| = {err:.3e}, "
              f"max|kernel - mirror| = {err_m:.3e}, max ||AX - I||inf = {resid:.3e} "
              f"(tol {tol:g})")
        check(err <= tol, f"K2 disagrees with plain at ({M}, {n}) {dtype}: {err}")
        check(err_m <= tol, f"K2 disagrees with its mirror at ({M}, {n}) {dtype}: {err_m}")
        check(resid < 1e-3, f"K2 inverse residual at ({M}, {n}) {dtype}: {resid}")
        errs[(M, n, dtype)] = err
    # every size the kernel takes, against the mirror and the plain version
    # (37 matrices: several warps and a ragged last one)
    for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
        worst_m = worst_p = 0.0
        for n in range(1, kb.MAX_N + 1):
            A = _equilibrated_inputs(37, n, dtype, seed=n)
            X = kb.gj_blocks_cuda(A)
            worst_m = max(worst_m, float((X - kb.gj_blocks_mirror(A)).abs().max()))
            worst_p = max(worst_p, float((X - kb.gj_blocks_plain(A)).abs().max()))
        print(f"K2 {str(dtype)[6:]} n = 1..{kb.MAX_N} (M = 37): max|kernel - mirror| = "
              f"{worst_m:.3e}, max|kernel - plain| = {worst_p:.3e} (tol {tol:g})")
        check(worst_m <= tol and worst_p <= tol, f"K2 disagrees at some n in {dtype}")
    # blocks of real Newton matrices: as close to the float64 inverse as the
    # plain float32 version is
    for G in groups:
        n = G.shape[-1]
        A64 = G.reshape(-1, n, n).to("cuda").repeat(128, 1, 1).contiguous()
        ref = kb.gj_blocks_plain(A64)
        scale = float(ref.abs().max())
        e_k = float((kb.gj_blocks_cuda(A64.float()).double() - ref).abs().max()) / scale
        e_p = float((kb.gj_blocks_plain(A64.float()).double() - ref).abs().max()) / scale
        e_m = float((kb.gj_blocks_mirror(A64.float()).double() - ref).abs().max()) / scale
        e_64 = float((kb.gj_blocks_cuda(A64) - ref).abs().max()) / scale
        print(f"K2 real blocks {tuple(A64.shape)}: f32 error vs f64 / scale: kernel "
              f"{e_k:.3e}, plain {e_p:.3e}, mirror {e_m:.3e}; f64 kernel vs plain {e_64:.3e}")
        check(e_k <= 4 * e_p + 1e-5, f"K2 less accurate than plain on real blocks: {e_k}")
        check(e_64 <= 1e-10, f"K2 float64 disagrees on real blocks: {e_64}")

    shapes = []
    # path 2's shapes, then path 7's (256 cells); at least 60 MB of rotating
    # inputs, beyond the 50 MB L2
    for M, n in ((10240, 10), (1024, 30), (2560, 10), (256, 30)):
        rot = max(K2_ROTATING, -(-60_000_000 // (M * n * n * 4)))
        bufs = [_equilibrated_inputs(M, n, torch.float32, seed=3 + i) for i in range(rot)]
        ms, host_us = device_ms(kb.gj_blocks_cuda, bufs, reps=200)
        b2b_ms = cuda_time_ms(lambda: kb.gj_blocks_cuda(bufs[0]), reps=100)
        plain_ms, _ = device_ms(kb.gj_blocks_plain, bufs, reps=8, spin=False)
        inv_ex = lambda A: torch.linalg.inv_ex(A)[0]  # noqa: E731
        # at n = 30 inv_ex synchronises the device itself: timed without the
        # spin, its host waits are part of what it costs
        lib_spin = not waits_for_device(inv_ex, bufs[0])
        library_ms, lib_host_us = device_ms(inv_ex, bufs, reps=20, spin=lib_spin)
        flops, n_bytes = cost.gj_blocks(M, n, 4)
        bound_ms, by = cost.bound(n_bytes, flops)
        print(f"K2 timing ({M}, {n}, {n}) f32, {rot} rotating inputs "
              f"({rot * n_bytes / 2e6:.1f} MB): kernel {ms:.4f} ms (back to back "
              f"on one input, no spin: {b2b_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"torch.linalg.inv_ex {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
              f"{n_bytes / 1e6:.1f} MB; {bound_ms / ms:.1%} of it reached); host "
              f"{host_us:.1f} us per gj_blocks_cuda call, {lib_host_us:.1f} us per inv_ex call"
              f"{'' if lib_spin else ' (inv_ex waits for the device: timed without the spin)'}")
        shapes.append(dict(shape=[M, n, n], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=by))
    return dict(max_abs_err=errs[(10240, 10, torch.float32)],
                **{k: shapes[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by")},
                shapes=shapes)


def phase_k3(Dp, sizes, sei=None):
    """K3 against its plain version and mirror (see the module docstring),
    timed at path 2's shape and, with `sei` = (permuted cores, sizes), at
    path 7's (256, 92, 92)."""
    import numpy as np
    import torch
    from petlion_tpu_torch.ops import cost, dchain as kd
    err_rec = None
    for B in (1024, 5):
        reps = -(-B // Dp.shape[0])
        D64 = Dp.to("cuda").repeat(reps, 1, 1)[:B].contiguous()
        ref = kd.dchain_plain(D64, sizes)
        got32 = kd.dchain_cuda(D64.float(), sizes)
        plain32 = kd.dchain_plain(D64.float(), sizes)
        got64 = kd.dchain_cuda(D64, sizes)
        mirror32 = kd.dchain_mirror(D64.float(), sizes)
        torch.cuda.synchronize()
        worst = 0.0
        for i, (k32, p32, m32, k64, r) in enumerate(zip(got32, plain32, mirror32,
                                                         got64, ref)):
            scale = float(r.abs().max())
            e_k = float((k32.double() - r).abs().max()) / scale
            e_p = float((p32.double() - r).abs().max()) / scale
            e_m = float((m32.double() - r).abs().max()) / scale
            e_kp = float((k32 - p32).abs().max())
            e_64 = float((k64 - r).abs().max()) / scale
            print(f"K3 B={B} output {i} {tuple(r.shape[1:])}: f32 error vs f64 / scale: "
                  f"kernel {e_k:.3e}, plain {e_p:.3e}, mirror {e_m:.3e}; max|kernel - "
                  f"plain| f32 {e_kp:.3e}; f64 kernel vs plain / scale {e_64:.3e}")
            check(e_k <= 4 * e_p + 1e-5,
                  f"K3 output {i} at B={B}: kernel error {e_k} vs plain {e_p}")
            check(e_64 <= 1e-8, f"K3 float64 output {i} at B={B}: {e_64}")
            worst = max(worst, e_kp)
        if B == 1024:
            err_rec = worst
    # other level sizes the kernel takes, on diagonally dominant cores
    rng = np.random.default_rng(3)
    for (B, m, lv), dtype, tol in (
            ((64, 101, (35, 35)), torch.float32, 1e-4),
            ((64, 101, (35, 35)), torch.float64, 1e-11),
            ((16, 100, (10, 33, 5, 20)), torch.float32, 1e-4),
            ((16, 139, ()), torch.float32, 1e-4), ((16, 98, ()), torch.float64, 1e-11),
            ((16, 40, (7,)), torch.float64, 1e-11), ((7, 33, (32,)), torch.float32, 1e-4)):
        Dr = (0.3 * rng.standard_normal((B, m, m))
              + 15.0 * np.eye(m) * rng.uniform(0.1, 10.0, (B, 1, m)))
        Dr = torch.as_tensor(Dr, dtype=dtype, device="cuda")
        worst = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(kd.dchain_cuda(Dr, lv), kd.dchain_plain(Dr, lv)))
        print(f"K3 {str(dtype)[6:]} ({B}, {m}, {m}) sizes {lv}: max |kernel - plain| / "
              f"scale {worst:.3e} (tol {tol:g})")
        check(worst <= tol, f"K3 disagrees with plain at n={m} sizes {lv} {dtype}: {worst}")

    shapes = []
    for D, lv, B, rot in ((Dp, sizes, 1024, ROTATING),) + (
            ((sei[0], sei[1], 256, 2 * ROTATING),) if sei is not None else ()):
        m = D.shape[-1]
        bufs = [D.to("cuda").float().repeat(-(-B // D.shape[0]), 1, 1)[:B].contiguous()
                for _ in range(rot)]
        check(all(torch.isfinite(o).all() for o in kd.dchain_cuda(bufs[0], lv)),
              f"K3 at ({B}, {m}): non-finite output")
        ms, host_us = device_ms(lambda X: kd.dchain_cuda(X, lv), bufs, reps=200)
        plain_ms, _ = device_ms(lambda X: kd.dchain_plain(X, lv), bufs, reps=8, spin=False)
        flops, n_bytes = cost.dchain(B, m, lv, 4)
        bound_ms, by = cost.bound(n_bytes, flops)
        print(f"K3 timing ({B}, {m}, {m}) sizes {lv} f32, {rot} rotating inputs: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no single PyTorch call computes "
              f"the chain, bound {bound_ms:.4f} ms ({by}: "
              f"{n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP; {bound_ms / ms:.1%} of it "
              f"reached); host {host_us:.1f} us per dchain_cuda call")
        shapes.append(dict(shape=[B, m, m], sizes=list(lv), ms=ms, plain_ms=plain_ms,
                           library_ms=None, bound_ms=bound_ms, bound_by=by))
    return dict(max_abs_err=err_rec,
                **{k: shapes[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by")},
                shapes=shapes)


def drive_path(mp, p, name, route, oracle, n_cells, needs, go=None, **opts):
    """Drive one path once with the launch counts set to 0 just before and
    read just after; check it; return (launches, result). `go` runs the
    path (default: ``mp.run`` of `n_cells` cells on `route` with `opts`)."""
    import numpy as np
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver import run as runner
    if go is None:
        def go():
            return mp.run(p, seed=0, route=route, n_cells=n_cells, **opts)
    gk.reset_launch_counts()
    runner.reset_trip_counts()
    res, wall = go()
    launches = dict(gk.LAUNCHES)
    flags = res.flag.cpu().numpy()
    steps = res.n_steps.cpu().numpy().astype(float)
    att = steps + res.n_rejected.cpu().numpy()
    t_end = float(res.t_final[0])
    V_end = float(p.layout.V(res.y_final[0]))
    print(f"{name} (first run, includes plan build): {wall:.3f} s for {n_cells} cells, "
          f"launches {launches}")
    print(f"  flags {dict(zip(*np.unique(flags, return_counts=True)))}; "
          f"steps/cell mean {steps.mean():.2f}, attempts/cell mean "
          f"{att.mean():.2f} max {att.max():.0f}")
    print(f"  cell 0: t_end {t_end:.4f} s (oracle {float(oracle['t_end']):.4f}), "
          f"V_end {V_end:.5f} V (oracle {float(oracle['V_end']):.5f})")
    for k in needs:
        check(launches[k] > 0, f"{name} never launched the {k} kernel")
    check(bool(np.isin(flags, (0, 1, 3)).all()),
          f"{name}: cells exited with flags {sorted(set(flags.tolist()))}")
    check(bool(np.isfinite(res.y_final.cpu().numpy()).all()), f"{name}: non-finite final states")
    check(abs(t_end - float(oracle["t_end"])) <= 5.0, f"{name}: cell 0 exit time off the oracle")
    check(abs(V_end - float(oracle["V_end"])) <= 8e-3, f"{name}: cell 0 V_end off the oracle")
    return launches, res


def phase_main(card):
    import numpy as np
    from petlion_tpu_torch import main_path as mp

    p = mp.model(device="cuda")
    oracle = np.load(ORACLE)
    launches, results, trip_s = {}, {}, {}
    for name, route, needs in (("path 1", mp.PATH1, ("gj_inverse",)),
                               ("path 2", mp.PATH2, ("gj_inverse", "gj_blocks", "dchain"))):
        launches[name], results[name] = drive_path(mp, p, name, route, oracle,
                                                   mp.B_MAIN, needs)
        if "dchain" in needs:
            # three group inverses (cathode, anode, c_e) per factorisation
            check(launches[name]["gj_blocks"] == 3 * launches[name]["dchain"],
                  f"{name}: {launches[name]['gj_blocks']} K2 launches for "
                  f"{launches[name]['dchain']} factorisations, not 3 each")
        # a warm run of one batch in this process: the end-to-end metric
        res2, walls, med, spread = mp.warm_walls(p, seed=1, route=route, runs=EARLY_WARM)
        check(bool(np.isin(res2.flag.cpu().numpy(), (0, 1, 3)).all()),
              f"{name} warm run: bad flags")
        att2 = (res2.n_steps + res2.n_rejected).cpu().numpy()
        print(f"{name} (warm, {len(walls)} runs of one batch): walls "
              f"{', '.join(f'{w:.3f}' for w in walls)} s, median {med:.3f} s = "
              f"{mp.B_MAIN / med:.1f} discharges/s, spread {spread:.1%}; steps/cell "
              f"mean {res2.n_steps.float().mean().item():.2f}, attempts/cell mean "
              f"{att2.mean():.2f} max {att2.max()} [{card}]")
        trip_s[name] = float(med / att2.max())  # a trip per attempt of the slowest cell
    drive_path(mp, p, "colored route", mp.COLORED, oracle, 64, ("gj_inverse",))
    return launches, results["path 1"], trip_s["path 1"]


def phase_simulate(card, oracle):
    """Path 3: the golden single-cell flow through `simulate` on the card
    in float64 (default route, K1 for the 71x71 core): discharge, rest,
    interpolation through the native spline, checkpoint and resume, and the
    float32 discharge. Returns the K1 launches of the phase and the float64
    discharge's (t_end, V_end), which path 13(a) is held to."""
    import tempfile
    import numpy as np
    import torch
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.runtime import native

    check(native.available(), "the native runtime did not build")
    spline_calls = [0]
    spline = native.spline_interp

    def counted(*args, **kwargs):
        spline_calls[0] += 1
        return spline(*args, **kwargs)

    p = ptt.petlion(ptt.LCO, device="cuda", dtype=torch.float64)
    gk.reset_launch_counts()
    sol, wall = mp.run_single(p)
    t_end, V_end = float(sol.t[-1]), float(sol.V[-1])
    r = sol.results[-1]
    print(f"simulate (first run, includes plan build): {wall:.3f} s, exit "
          f"{sol.final_exit_reason()!r}, t_end {t_end:.4f} s (oracle "
          f"{float(oracle['t_end']):.4f}), V_end {V_end:.5f} V (golden 2.9357, oracle "
          f"{float(oracle['V_end']):.5f}); steps {r.n_steps}, attempts "
          f"{r.n_steps + r.n_rejected}, {len(sol.t)} saved points")
    check(sol.final_exit_reason() == "Below min. SOC", "simulate: wrong exit")
    check(abs(t_end - 3600.0) <= 5.0, f"simulate: exit at {t_end} s")
    check(abs(V_end - 2.9357) <= 8e-3, f"simulate: V_end {V_end} off the golden")
    check(abs(t_end - float(oracle["t_end"])) <= 5.0, "simulate: exit time off the oracle")
    check(abs(V_end - float(oracle["V_end"])) <= 8e-3, "simulate: V_end off the oracle")
    check(bool(np.isfinite(sol.Y_final).all()), "simulate: non-finite final state")

    sol = ptt.simulate_cont(sol, p, 600.0, I="rest")
    print(f"simulate_cont(I='rest', 600 s): exits {sol.exit_reasons()}, t_end "
          f"{float(sol.t[-1]):.4f} s, V_end {float(sol.V[-1]):.5f} V")
    check(sol.final_exit_reason() == "Final time reached" and len(sol) == 2,
          "simulate_cont: wrong exit or run count")

    grid = np.linspace(0.0, float(sol.t[-1]), 200)
    native.spline_interp = counted
    try:
        dense = sol(grid)
    finally:
        native.spline_interp = spline
    print(f"sol(t) on {len(grid)} points: {spline_calls[0]} native spline calls, "
          f"V in [{dense.V.min():.5f}, {dense.V.max():.5f}] V")
    check(spline_calls[0] > 0, "sol(t) did not go through the native spline")
    check(dense.V.shape == grid.shape and bool(np.isfinite(dense.V).all()),
          "sol(t): bad interpolated V")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "checkpoint.npz")
        sol.save(path)
        loaded = ptt.Solution.load(path)
    check(np.array_equal(loaded.V, sol.V) and loaded.exit_reasons() == sol.exit_reasons(),
          "checkpoint: the loaded solution differs")
    loaded = ptt.simulate_cont(loaded, p, 300.0, I="rest")
    print(f"checkpoint saved, loaded and resumed: exits {loaded.exit_reasons()}, "
          f"t_end {float(loaded.t[-1]):.4f} s")
    check(loaded.final_exit_reason() == "Final time reached" and len(loaded) == 3
          and abs(float(loaded.t[-1]) - float(sol.t[-1]) - 300.0) < 1e-6,
          "resume from the checkpoint failed")

    s32, wall32 = mp.run_single(p, dtype=torch.float32, abstol=1e-3)
    tq = np.linspace(50.0, 3500.0, 30)
    s64 = sol[0]
    # each trace read through its own Solution interpolation; straight lines
    # between the saved points (printed beside) add the chords' own error
    dv = float(np.max(np.abs(s32(tq).V - s64(tq).V)))
    dv_lin = float(np.max(np.abs(np.interp(tq, s32.t, s32.V) - np.interp(tq, s64.t, s64.V))))
    print(f"simulate float32 (abstol 1e-3): {wall32:.3f} s, exit "
          f"{s32.final_exit_reason()!r} at {float(s32.t[-1]):.4f} s, max |V32 - V64| "
          f"{dv * 1e3:.3f} mV on 30 points ({dv_lin * 1e3:.3f} mV between straight "
          f"lines through the saved points)")
    check(s32.final_exit_reason() == "Below min. SOC", "float32 simulate: wrong exit")
    check(dv < 5e-3, f"float32 simulate: {dv} V off the float64 trace")
    launches = gk.LAUNCHES["gj_inverse"]
    print(f"simulate phase: {launches} K1 launches")
    check(launches > 0, "the simulate phase never launched K1")

    return launches, (t_end, V_end)


def phase_tstops(card, oracle, path1):
    """Path 4: path 1's batch with three stop times per cell and a shared
    discontinuity. Returns the K1 launches of its first run."""
    import numpy as np
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk

    p = mp.model(device="cuda")
    gk.reset_launch_counts()
    res, wall = mp.run_tstops(p, seed=0)
    launches = gk.LAUNCHES["gj_inverse"]
    flags = res.flag.cpu().numpy()
    n_saved = res.n_saved.cpu().numpy()
    t = res.bufs["t"].cpu().numpy()
    stops = np.concatenate([mp.tstops(0), np.full((mp.B_MAIN, 1),
                            mp.TDISCON[0] - p.opts.reltol / 2)], axis=1)
    mask = np.arange(t.shape[1])[None, :] < n_saved[:, None]
    dist = np.where(mask[:, None, :], np.abs(t[:, None, :] - stops[:, :, None]), np.inf)
    worst = float(dist.min(axis=2).max())
    steps = res.n_steps.cpu().numpy().astype(float)
    att = steps + res.n_rejected.cpu().numpy()
    s1 = path1.n_steps.cpu().numpy().astype(float)
    a1 = s1 + path1.n_rejected.cpu().numpy()
    t_end = float(res.t_final[0])
    V_end = float(p.layout.V(res.y_final[0]))
    print(f"tstops (first run): {wall:.3f} s for {mp.B_MAIN} cells, {launches} K1 "
          f"launches; flags {dict(zip(*np.unique(flags, return_counts=True)))}; "
          f"worst distance from a stop to its nearest recorded t {worst:.3e} s")
    print(f"  steps/cell mean {steps.mean():.2f} (path 1 {s1.mean():.2f}, difference "
          f"{steps.mean() - s1.mean():+.2f} for 4 stops), attempts/cell mean "
          f"{att.mean():.2f} (path 1 {a1.mean():.2f}, {att.mean() - a1.mean():+.2f}); "
          f"cell 0: t_end {t_end:.4f} s, V_end {V_end:.5f} V (oracle "
          f"{float(oracle['V_end']):.5f})")
    check(launches > 0, "the tstops phase never launched K1")
    check(bool((flags == 3).all()), f"tstops: flags {sorted(set(flags.tolist()))}")
    check(not bool(res.truncated.any()), "tstops: a cell's record overflowed max_save")
    check(worst <= 1e-2, f"tstops: a stop missed by {worst} s")
    check(abs(t_end - float(oracle["t_end"])) <= 5.0, "tstops: cell 0 exit time off the oracle")
    check(abs(V_end - float(oracle["V_end"])) <= 8e-3, "tstops: cell 0 V_end off the oracle")
    return launches


def check_gitt(res, t_off, tf):
    """Path 5's checks on one run's result; returns the worst distance from
    a pulse end to its nearest recorded time."""
    import numpy as np
    flags = res.flag.cpu().numpy()
    n_saved = res.n_saved.cpu().numpy()
    t = res.bufs["t"].cpu().numpy().astype(np.float64)
    I = res.bufs["I"].cpu().numpy().astype(np.float64)
    saved = np.arange(t.shape[1])[None, :] < n_saved[:, None]
    check(bool((flags == 0).all()), f"gitt: flags {sorted(set(flags.tolist()))}")
    check(not bool(res.truncated.any()), "gitt: a cell's record overflowed max_save")
    check(bool(np.isfinite(res.y_final.cpu().numpy()).all()), "gitt: non-finite final states")
    gap = np.where(saved, np.abs(t - t_off[:, None]), np.inf).min(axis=1)
    worst = float(gap.max())
    check(worst < 1e-2, f"gitt: a pulse end missed by {worst} s")
    before = saved & (t < t_off[:, None] - 0.01)
    after = saved & (t > t_off[:, None] + 0.5)
    check(bool((np.abs(I + 1.0)[before] < 1e-3).all()), "gitt: |I + 1| >= 1e-3 before a pulse end")
    check(bool(after.any(axis=1).all()), "gitt: a cell recorded nothing after its pulse end")
    check(bool((np.abs(I)[after] < 1e-3).all()), "gitt: |I| >= 1e-3 after a pulse end")
    t_last = t[np.arange(len(t)), n_saved - 1]
    check(bool((np.abs(t_last - tf) < 1.0).all()), "gitt: a cell ended short of tf")
    return worst


def phase_gitt(card):
    """Path 5: the batched GITT pulse. Returns the K1 launches of its first
    run."""
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver import run as runner

    p = mp.model(device="cuda")
    gk.reset_launch_counts()
    runner.reset_trip_counts()
    res, wall = mp.run_gitt(p, seed=0)
    launches = gk.LAUNCHES["gj_inverse"]
    trips = dict(runner.TRIPS)
    t_off = mp.t_pulse_off(0)
    worst = check_gitt(res, t_off, mp.GITT_TF)
    steps = res.n_steps.cpu().numpy().astype(float)
    att = steps + res.n_rejected.cpu().numpy()
    print(f"gitt (first run): {wall:.3f} s for {mp.B_MAIN} cells, {launches} K1 launches, "
          f"{trips['trips']} trips, {trips['reinit']} of them ran a re-initialization "
          f"({trips['reinit_s']:.3f} s of host wall in them); worst distance from a pulse "
          f"end to its nearest recorded t {worst:.3e} s; steps/cell mean {steps.mean():.2f}, "
          f"attempts/cell mean {att.mean():.2f} max {att.max():.0f}")
    check(launches > 0, "the gitt phase never launched K1")
    check(trips["reinit"] > 0, "the gitt phase never re-initialized")
    return launches


def check_cccv(sol):
    """Path 6's CC→CV checks on the chained Solution."""
    import numpy as np
    reasons = sol.exit_reasons()
    check(len(sol) == 2 and reasons[0] == "Above max. voltage",
          f"cccv: exits {reasons}")
    if reasons[1] == "Below min. C-rate":
        check(abs(float(sol.I[-1]) - 0.05) < 5e-3, f"cccv: taper ended at I {sol.I[-1]}")
    else:
        check(reasons[1] == "Above max. SOC", f"cccv: the taper ended with {reasons[1]!r}")
    r0, r1 = sol.results
    P0, P1 = float(sol.P[r0.run_index][-1]), float(sol.P[r1.run_index][0])
    check(abs(P1 - P0) <= 1e-3 * abs(P0), f"cccv: power jumps {P0} -> {P1} at the boundary")
    check(bool(np.isfinite(sol.Y_final).all()), "cccv: non-finite final state")
    return P0, P1


def phase_cccv(card):
    """Path 6: CC→CV, constant power and plating overpotential on one cell
    in float64. Returns the K1 launches of the phase."""
    import torch
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk

    p = ptt.petlion(ptt.LCO, device="cuda", dtype=torch.float64)
    gk.reset_launch_counts()
    sol, wall = mp.run_cccv(p)
    P0, P1 = check_cccv(sol)
    r0, r1 = sol.results
    print(f"cccv (first run, includes plan build): {wall:.3f} s, exits {sol.exit_reasons()} "
          f"at {r0.tspan[1]:.2f} s and {r1.tspan[1]:.2f} s, final I {float(sol.I[-1]):.5f}C, "
          f"V {float(sol.V[-1]):.5f} V, SOC {float(sol.SOC[-1]):.5f}; power at the boundary "
          f"{P0:.6f} -> {P1:.6f} W/m2; steps {r0.n_steps} + {r1.n_steps}, attempts "
          f"{r0.n_steps + r0.n_rejected} + {r1.n_steps + r1.n_rejected}")
    sP, wP = mp.run_power(p)
    check(sP.final_exit_reason() == "Final time reached" and abs(float(sP.P[-1]) + 10.0) < 1e-6,
          f"P=-10: exit {sP.final_exit_reason()!r}, P_end {sP.P[-1]}")
    sE, wE = mp.run_eta(p)
    eta = float(p.layout.eta_plating(sE.Y_final))
    check(sE.final_exit_reason() == "Final time reached" and abs(eta - 0.05) < 1e-6,
          f"eta_p=0.05: exit {sE.final_exit_reason()!r}, eta_p {eta}")
    launches = gk.LAUNCHES["gj_inverse"]
    print(f"P = -10 W/m2, 600 s: {wP:.3f} s, P_end {float(sP.P[-1]):.9f}, steps "
          f"{sP.results[0].n_steps}; eta_p = 0.05 V, 60 s: {wE:.3f} s, eta_p_end {eta:.9f}, "
          f"steps {sE.results[0].n_steps}; cccv phase: {launches} K1 launches")
    check(launches > 0, "the cccv phase never launched K1")
    return launches


def _ptxas_instance(log, tag):
    """(registers, (spill store bytes, spill load bytes)) of the last kernel
    instance whose mangled name contains `tag`, from nvcc's -Xptxas -v
    output ((None, None) where ptxas did not report one)."""
    from petlion_tpu_torch.ops import gj_kernel as gk
    rows = [r for r in gk.ptxas_report(log) if tag in r[0]]
    return (rows[-1][1], (rows[-1][2], rows[-1][3])) if rows else (None, None)


def phase_k1_core92(cores):
    """K1 at the cores of path 7 (NMC+SEI, 92 states) and of the stress
    model (91): random equilibrated matrices at (256, n) in float32 against
    the plain blocked version, the mirror and a float64 inverse; the real
    equilibrated cores (8 states tiled to 256) in float32 against float64,
    as accurate as the plain versions; float64 against the mirror. Times the
    kernel at (256, 92) float32 over rotating inputs behind the spin, beside
    its bound, the plain version and torch.linalg.inv_ex, and prints the
    registers and spills of the tile instance it takes there (T = 16, P = 8)."""
    import torch
    from petlion_tpu_torch.ops import gj_kernel as gk
    record = None
    for label, D in cores:
        n = D.shape[-1]
        A = _equilibrated_inputs(256, n, torch.float32, seed=256000 + n)
        X = gk.gj_inverse_cuda(A)
        err = float((X - gk.gj_inverse_blocked(A, bs=gk._best_bs(n))).abs().max())
        err_m = float((X - gk.gj_inverse_inplace(A)).abs().max())
        X64 = torch.linalg.inv(A.double())
        err_64 = float(((X.double() - X64).abs()
                        / X64.abs().amax(dim=(-2, -1), keepdim=True)).max())
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        resid = float((A.double() @ X.double() - eye).abs().amax(dim=(-2, -1)).max())
        print(f"K1 f32 (256, {n}) [{label} core size]: max|kernel - plain| = {err:.3e}, "
              f"max|kernel - mirror| = {err_m:.3e}, vs the float64 inverse / scale "
              f"{err_64:.3e}, max ||AX - I||inf = {resid:.3e}")
        check(err <= 2e-4 and err_m <= 2e-4, f"K1 disagrees with plain at (256, {n})")
        check(err_64 <= 1e-5 and resid < 1e-3, f"K1 inverse off at (256, {n})")

        shape, e = _k1_real_cores(D, 32)
        print(f"K1 real {label} cores {shape}: f32 error vs f64 / scale: kernel "
              f"{e['kernel']:.3e}, mirror {e['mirror']:.3e}, blocked bs=8 {e['b8']:.3e}; "
              f"f64 kernel vs mirror {e['f64']:.3e}")
        check(e["kernel"] <= 4 * e["mirror"] + 1e-5 and e["kernel"] <= 4 * e["b8"] + 1e-5,
              f"K1 less accurate than plain on the real {label} cores: {e['kernel']}")
        check(e["f64"] <= 1e-8, f"K1 float64 disagrees on the real {label} cores: {e['f64']}")
        if record is None:
            record = dict(max_abs_err=err)

    n = cores[0][1].shape[-1]
    record.update(_k1_timing(256, n, 8, seed=92))     # 8 × 8.7 MB, beyond the L2
    regs, spill = _ptxas_instance(gk.BUILD_LOGS.get("gj_inverse", ""),
                                  "gj_inverse_kernelIfLi16ELi8E")
    print(f"K1 tile T = 16, P = 8 (float), which n = {n} takes: {regs} registers, spill "
          f"stores/loads {spill} bytes")
    record.update(shape=[256, n, n], registers=regs,
                  spill_bytes=None if spill is None else list(spill))
    return record


def check_sei(res, p, name):
    """Path 7's per-cell checks: flag 0, 1 or 3; the recorded SOH
    non-increasing (to 1e-12); film ≥ 0; finite final states."""
    import numpy as np
    flags = res.flag.cpu().numpy()
    check(bool(np.isin(flags, (0, 1, 3)).all()),
          f"{name}: cells exited with flags {sorted(set(flags.tolist()))}")
    soh = res.bufs["SOH"][..., 0].cpu().double().numpy()
    n_saved = res.n_saved.cpu().numpy()
    rise = max(float(np.diff(soh[b, :n_saved[b]]).max(initial=0.0))
               for b in range(len(n_saved)))
    check(rise <= 1e-12, f"{name}: SOH rises by {rise}")
    y = res.y_final.cpu().double().numpy()
    film = y[:, p.layout.sl("film")]
    check(float(film.min()) >= 0.0, f"{name}: negative film {film.min()}")
    check(bool(np.isfinite(y).all()), f"{name}: non-finite final states")
    return rise, float(film.max())


def phase_sei(card):
    """Path 7 (NMC with SEI aging, 256 cells, float32): the default route
    with K1 at the 92-state core, cell 0 against the same cell in float64
    on the card, the full-kernel route (K2, K3) against it.
    Returns (launches of route 1, launches of route 2)."""
    import numpy as np
    import torch
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk

    p = mp.sei_model(device="cuda")
    L = p.layout
    out = {}
    for name, route in (("path 7", mp.PATH1), ("path 7, full-kernel route", mp.PATH2)):
        gk.reset_launch_counts()
        res, wall = mp.run_sei(p, seed=0, route=route)
        launches = dict(gk.LAUNCHES)
        by_n = {k: dict(sorted(v.items())) for k, v in gk.LAUNCHES_BY_N.items()}
        rise, film_max = check_sei(res, p, name)
        steps = res.n_steps.cpu().numpy().astype(float)
        att = steps + res.n_rejected.cpu().numpy()
        flags = res.flag.cpu().numpy()
        print(f"{name} (first run, includes plan build): {wall:.3f} s for {mp.SEI_B} cells, "
              f"launches {launches}, by n {by_n}; flags "
              f"{dict(zip(*np.unique(flags, return_counts=True)))}; steps/cell mean "
              f"{steps.mean():.2f}, attempts/cell mean {att.mean():.2f} max {att.max():.0f}; "
              f"largest SOH rise {rise:.1e}, largest film {film_max:.3e} m")
        out[name] = (launches, by_n, res)
    launches1, by_n1, res1 = out["path 7"]
    launches2, by_n2, res2 = out["path 7, full-kernel route"]
    check(by_n1["gj_inverse"].get(92, 0) > 0, "path 7 never launched K1 at n = 92")
    check(launches2["gj_blocks"] > 0 and launches2["dchain"] > 0,
          "path 7's full-kernel route did not launch K2 and K3")
    check(by_n2["dchain"].get(92, 0) > 0, "path 7's full-kernel route never ran K3 at n = 92")

    # route 2 against route 1, per cell: V on the saved points while the two
    # routes step in lockstep (recorded times within 1e-2 s; float32 rounding
    # of the two factorizations moves the step sizes apart later), V and
    # time at the exit
    t1, V1 = (res1.bufs[k].cpu().double().numpy() for k in ("t", "V"))
    t2, V2 = (res2.bufs[k].cpu().double().numpy() for k in ("t", "V"))
    n1, n2 = res1.n_saved.cpu().numpy(), res2.n_saved.cpu().numpy()
    dv_routes, n_lock = 0.0, 0
    for b in range(len(n1)):
        m = min(n1[b], n2[b])
        close = np.abs(t1[b, :m] - t2[b, :m]) <= 1e-2
        k = m if close.all() else int(np.argmin(close))
        n_lock += k
        if k:
            dv_routes = max(dv_routes, float(np.abs(V1[b, :k] - V2[b, :k]).max()))
    dv_end = float((L.V(res1.y_final) - L.V(res2.y_final)).abs().max())
    dt_end = float(((res1.t_final - res2.t_final).abs() / res1.t_final).max())
    print(f"path 7 full-kernel route against the default route: max |dV| {dv_routes:.3e} V "
          f"on {n_lock} of {int(n1.sum())} saved points in lockstep, {dv_end:.3e} V and "
          f"{dt_end:.2e} (relative) in time at the exit; steps equal in "
          f"{int((res1.n_steps == res2.n_steps).sum())} of {mp.SEI_B} cells")
    check(dv_routes <= 1e-4 and dv_end <= 1e-4, "path 7: the two routes disagree in V")
    check(dt_end <= 1e-4, "path 7: the two routes exit at different times")

    # cell 0 (published θ) against the same cell in float64 on the card
    p64 = mp.sei_model(device="cuda", dtype=torch.float64)
    s64 = ptt.simulate(p64, mp.TF, I=-1, SOC=1)
    tq = t1[0, :n1[0]]
    tq = tq[tq <= float(s64.t[-1]) - 100.0]
    dv64 = float(np.abs(s64(tq).V - np.interp(tq, t1[0, :n1[0]], V1[0, :n1[0]])).max())
    print(f"path 7 cell 0 float32 against float64 on the card: max |dV| {dv64 * 1e3:.3f} mV "
          f"on {len(tq)} saved points up to 100 s before the exit; exit "
          f"{float(res1.t_final[0]):.3f} s against {float(s64.t[-1]):.3f} s "
          f"({s64.final_exit_reason()!r})")
    check(dv64 <= 2e-3, f"path 7 cell 0: {dv64} V off the float64 run")

    return launches1, by_n1, launches2


# one cycle of the suite's three (the script's time limit; main_path.py runs three)
SEI_CYCLES = 1
SEI_CYCLING_EXITS = ["Above max. SOC"] + ["Below min. SOC", "Above max. SOC"] * SEI_CYCLES


def phase_sei_cycling(card):
    """The SEI cycling chain (SEI_CYCLES cycles of the suite's three) on one
    float32 cell: the exit
    sequence of the JAX suite's 4_sei_cycling, SOH non-increasing over the
    chain, the final SOH within 1e-5 (relative) of the float64 chain on the
    card. Returns the K1 launches of the float32 chain."""
    import numpy as np
    import torch
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk

    soh_end = {}
    for dtype in (torch.float32, torch.float64):
        p = mp.sei_model(device="cuda", dtype=dtype)
        gk.reset_launch_counts()
        sol, wall = mp.run_sei_cycling(p, cycles=SEI_CYCLES)
        if dtype == torch.float32:
            launches = gk.LAUNCHES["gj_inverse"]
        soh = np.asarray(sol.arrays["SOH"], dtype=np.float64)[:, 0]
        rise = float(np.diff(soh).max())
        soh_end[dtype] = float(soh[-1])
        print(f"sei cycling {str(dtype)[6:]}: {wall:.3f} s, exits {sol.exit_reasons()}, "
              f"final SOH {soh[-1]:.7f}, largest SOH rise {rise:.1e}, steps "
              f"{[r.n_steps for r in sol.results]}, attempts "
              f"{[r.n_steps + r.n_rejected for r in sol.results]}")
        check(sol.exit_reasons() == SEI_CYCLING_EXITS,
              f"sei cycling {dtype}: exits {sol.exit_reasons()}")
        check(rise <= 1e-12, f"sei cycling {dtype}: SOH rises by {rise}")
    gap = abs(soh_end[torch.float32] - soh_end[torch.float64]) / soh_end[torch.float64]
    print(f"sei cycling: final SOH float32 against float64 {gap:.2e} (relative); "
          f"{launches} K1 launches in the float32 chain [{card}]")
    check(gap <= 1e-5, f"sei cycling: final SOH {gap} off the float64 chain")
    check(launches > 0, "the sei cycling chain never launched K1")
    return launches


VARIANTS = (("NMC_LGM50", dict(temperature=False, aging="stress")),
            ("LCO", dict(solid_diffusion="polynomial")),
            ("LCO", dict(Fickian_method="spectral")),
            ("LCO", dict(anode="Li_metal")))


def phase_variants(card):
    """One float64 cell, a 600 s 1C discharge from SOC 1, of each physics
    variant in VARIANTS, on the card and on the CPU in this process: the
    same exit and step counts, V within 1e-9, K1 launched on the card; then
    two half cells on the full-kernel route (K2 on the particle and c_e
    groups, none for the absent anode; K3 on the chain), card = CPU. Returns
    the K1 launches of the phase."""
    import numpy as np
    import torch
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE

    k1 = 0
    for chem, kw in VARIANTS:
        sols = {}
        for dev in ("cuda", "cpu"):
            p = ptt.petlion(getattr(ptt, chem), device=dev, dtype=torch.float64, **kw)
            gk.reset_launch_counts()
            sols[dev] = ptt.simulate(p, 600.0, I=-1, SOC=1)
            if dev == "cuda":
                launches = gk.LAUNCHES["gj_inverse"]
        a, b = sols["cuda"], sols["cpu"]
        ra, rb = a.results[-1], b.results[-1]
        dv = float(np.abs(a.V - b.V).max()) if len(a.V) == len(b.V) else float("inf")
        print(f"variant {chem}({kw}): N_tot {p.layout.N_tot}, exit {a.final_exit_reason()!r}, "
              f"steps {ra.n_steps} / {rb.n_steps} (card / CPU), rejected {ra.n_rejected} / "
              f"{rb.n_rejected}, max |V card - V CPU| {dv:.2e}, V_end {float(a.V[-1]):.6f}; "
              f"{launches} K1 launches")
        check(ra.flag == rb.flag and ra.n_steps == rb.n_steps
              and ra.n_rejected == rb.n_rejected, f"variant {chem}{kw}: card and CPU part")
        check(dv <= 1e-9, f"variant {chem}{kw}: V card - CPU {dv}")
        check(launches > 0, f"variant {chem}{kw} never launched K1")
        k1 += launches

    res = {}
    for dev in ("cuda", "cpu"):
        p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64, anode="Li_metal")
        gk.reset_launch_counts()
        res[dev] = ptt.batch_simulate(p, 600.0, I=-1.0, SOC=1.0, route=FULL_KERNEL_ROUTE,
                                      theta_batch={"D_sp": np.array([1e-14, 1.05e-14])})
        if dev == "cuda":
            by_n = {k: dict(sorted(v.items())) for k, v in gk.LAUNCHES_BY_N.items()}
    a, b = res["cuda"], res["cpu"]
    dy = float((a.y_final.cpu() - b.y_final).abs().max() / b.y_final.abs().max())
    print(f"half cell on the full-kernel route, 2 cells: launches by n {by_n}; "
          f"flags {a.flag.tolist()}, steps {a.n_steps.tolist()} / {b.n_steps.tolist()} "
          f"(card / CPU), max |y card - y CPU| / max |y| {dy:.2e} [{card}]")
    check(by_n["gj_blocks"] and by_n["dchain"], "half cell: K2 or K3 not launched")
    check(a.flag.tolist() == b.flag.tolist() and a.n_steps.tolist() == b.n_steps.tolist(),
          "half cell, full-kernel route: card and CPU part")
    check(dy <= 1e-9, f"half cell, full-kernel route: card - CPU {dy}")
    return k1


def phase_k1_core121(cores):
    """K1 at path 9's thermal core (121 states) in float64, the `<16, 8>`
    instance no earlier path ran: random equilibrated matrices at (128, 121)
    against the plain blocked version and its mirror (1e-10) and a float64
    torch.linalg.inv (1e-9 of the scale); the real thermal Newton cores
    under the dT hold (nearly singular: the pivot-free kernel and the plain
    version are each held against a pivoted float64 inverse, and the kernel
    must be as accurate as the plain version, 4× plus 1e-12) at (1, 121) and
    tiled to (128, 121); the time at both shapes over rotating inputs behind
    the spin, beside the bound, the plain version and torch.linalg.inv_ex;
    and the registers and spills of the float64 T = 16, P = 8 tile."""
    import torch
    from petlion_tpu_torch.ops import cost, gj_kernel as gk
    from petlion_tpu_torch.solver.linsolve import _equilibrate
    n = 121
    A = _equilibrated_inputs(128, n, torch.float64, seed=121)
    X = gk.gj_inverse_cuda(A)
    err = float((X - gk.gj_inverse_blocked(A, bs=gk._best_bs(n))).abs().max())
    err_m = float((X - gk.gj_inverse_inplace(A)).abs().max())
    X64 = torch.linalg.inv(A)
    err_inv = float(((X - X64).abs() / X64.abs().amax(dim=(-2, -1), keepdim=True)).max())
    print(f"K1 f64 (128, {n}) random: max|kernel - plain| = {err:.3e}, max|kernel - "
          f"mirror| = {err_m:.3e}, vs torch.linalg.inv / scale {err_inv:.3e}")
    check(err <= 1e-10 and err_m <= 1e-10, f"K1 f64 disagrees with plain at (128, {n})")
    check(err_inv <= 1e-9, f"K1 f64 inverse off at (128, {n}): {err_inv}")

    record = dict(max_abs_err=err)
    As = _equilibrate(cores.to("cuda"))[0].contiguous()
    for B in (1, 128):
        Ab = As.repeat(-(-B // As.shape[0]), 1, 1)[:B].contiguous()
        ref = torch.linalg.inv(Ab)
        scale = ref.abs().amax(dim=(-2, -1), keepdim=True)
        e_k = float(((gk.gj_inverse_cuda(Ab) - ref).abs() / scale).max())
        e_p = float(((gk.gj_inverse_blocked(Ab, bs=gk._best_bs(n)) - ref).abs() / scale).max())
        e_kp = float(((gk.gj_inverse_cuda(Ab) - gk.gj_inverse_inplace(Ab)).abs() / scale).max())
        print(f"K1 f64 real dT-hold thermal cores ({B}, {n}): relative error against a "
              f"pivoted float64 inverse: kernel {e_k:.3e}, plain {e_p:.3e}; kernel vs "
              f"mirror {e_kp:.3e}")
        check(e_k <= 4 * e_p + 1e-12, f"K1 f64 less accurate than plain on the thermal cores ({B})")

    shapes = []
    for B, rot in ((1, 64), (128, 8)):
        bufs = [_equilibrated_inputs(B, n, torch.float64, seed=1210 + i) for i in range(rot)]
        ms, host_us = device_ms(gk.gj_inverse_cuda, bufs, reps=200)
        plain_ms, _ = device_ms(lambda X: gk.gj_inverse_blocked(X, bs=gk._best_bs(n)), bufs,
                                reps=8, spin=False)
        library_ms, _ = device_ms(lambda X: torch.linalg.inv_ex(X)[0], bufs, reps=8,
                                  spin=False)
        flops, n_bytes = cost.gj_inverse(B, n, 8)
        bytes_ms, ops_ms = cost.bound(n_bytes, 0)[0], cost.bound(0, flops, fp64=True)[0]
        bound_ms, by = cost.bound(n_bytes, flops, fp64=True)
        print(f"K1 timing ({B}, {n}) f64, {rot} rotating inputs: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.linalg.inv_ex {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}: {n_bytes / 1e6:.2f} MB = {bytes_ms:.4f} ms, "
              f"{flops / 1e9:.4f} GFLOP = {ops_ms:.4f} ms at FP64 "
              f"{cost.PEAK_FP64_FLOP_PER_S / 1e12:.0f} TFLOP/s; "
              f"{bound_ms / ms:.1%} of it reached); host {host_us:.1f} us per call")
        shapes.append(dict(shape=[B, n, n], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=by))
    regs, spill = _ptxas_instance(gk.BUILD_LOGS.get("gj_inverse", ""),
                                  "gj_inverse_kernelIdLi16ELi8E")
    print(f"K1 tile T = 16, P = 8 (double), which n = {n} takes: {regs} registers, spill "
          f"stores/loads {spill} bytes")
    record.update({k: shapes[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by")})
    record.update(shape=[1, n, n], shapes=shapes, registers=regs,
                  spill_bytes=None if spill is None else list(spill))
    return record


def _reuse_line(res, path1):
    """Factorizations, attempts and rejections per cell of a run beside
    path 1's (the run's trip counts are in runner.TRIPS)."""
    from petlion_tpu_torch.solver import run as runner
    fac = sum(c.cpu().numpy() for c in runner.TRIPS["cell_factors"])
    att = (res.n_steps + res.n_rejected).cpu().numpy().astype(float)
    att1 = (path1.n_steps + path1.n_rejected).cpu().numpy().astype(float)
    rej, rej1 = (r.n_rejected.cpu().numpy().astype(float) for r in (res, path1))
    print(f"  {runner.TRIPS['factor_trips']} of {runner.TRIPS['trips']} trips factored the "
          f"Newton matrix; factorizations/cell mean {fac.mean():.2f} max {fac.max()}; "
          f"attempts/cell mean {att.mean():.2f} max {att.max():.0f} (path 1: "
          f"{att1.mean():.2f}, max {att1.max():.0f}); rejections/cell mean {rej.mean():.2f} "
          f"(path 1: {rej1.mean():.2f})")
    return fac, att


def phase_solver_options(card, oracle, path1, k1_path1):
    """Paths 11 and 12: path 1's 1024 cells with jac_reuse=6 (each cell
    factors once per chunk of at most six steps; K1 at n = 71 on the trips
    on which some cell starts a chunk) and with step_control="ida": every
    cell flag 0, 1 or 3, cell 0 within 5 s and 8e-3 V of the oracle, K1
    launched; factorizations per cell (fewer than attempts under reuse),
    attempts and rejections per cell beside path 1's.
    Returns the K1 launches of the two first runs."""
    from petlion_tpu_torch import main_path as mp
    p = mp.model(device="cuda")
    k1 = {}
    for label, opts in (("path 11 (jac_reuse=6)", mp.REUSE_OPTS),
                        ("path 12 (step_control='ida')", mp.IDA_OPTS)):
        launches, res = drive_path(mp, p, label, mp.PATH1, oracle, mp.B_MAIN,
                                   ("gj_inverse",), **opts)
        fac, att = _reuse_line(res, path1)
        k1[label] = launches["gj_inverse"]
        print(f"  K1 launches {launches['gj_inverse']} (path 1: {k1_path1})")
        if opts is mp.REUSE_OPTS:
            check(fac.mean() < att.mean() and fac.max() <= att.max(),
                  f"{label}: {fac.mean()} factorizations per cell for {att.mean()} attempts")
    return sum(k1.values())


def phase_dense(card, oracle, fast3):
    """Path 13, the dense routes, one cold run each: (a) the golden
    `simulate(p, I=-1, SOC=1, fast_solver=False)` of one float64 cell must
    exit "Below min. SOC" within 1 s of 3600 s, with t_end and V_end within
    rtol 1e-10 and 1e-8 of path 3's fast route (`fast3`); path 1's first 64
    cells in float32 (b) through `batch_simulate(fast_solver=False)`, (c)
    through `run_once(linear_solver=make_schur_solver(layout))`, K1 at the
    101-state particle-Schur core, and (d) through `run_once(jac_plan=
    get_plan(..., use_schur=False))`: every cell flag 0, 1 or 3, cell 0
    within 5 s and 8e-3 V of the oracle, K1 launched (by the initialization
    at n = 71 on (b) and (d)). Prints the peak device memory of each.
    Returns the K1 launches at n = 71 and at n = 101."""
    import torch
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.ops.plan import get_plan
    from petlion_tpu_torch.ops.structured import make_schur_solver

    p64 = ptt.petlion(ptt.LCO, device="cuda", dtype=torch.float64)
    gk.reset_launch_counts()
    sol, wall = mp.run_single(p64, fast_solver=False)
    t_end, V_end = float(sol.t[-1]), float(sol.V[-1])
    r = sol.results[-1]
    by_n = dict(gk.LAUNCHES_BY_N["gj_inverse"])
    print(f"path 13(a) simulate(fast_solver=False), float64 (first run): {wall:.3f} s, exit "
          f"{sol.final_exit_reason()!r}, t_end {t_end:.6f} s, V_end {V_end:.9f} V (path 3: "
          f"{fast3[0]:.6f} s, {fast3[1]:.9f} V; relative gaps {abs(t_end - fast3[0]) / fast3[0]:.2e}, "
          f"{abs(V_end - fast3[1]) / fast3[1]:.2e}); steps {r.n_steps}, attempts "
          f"{r.n_steps + r.n_rejected}; K1 by n {by_n}")
    check(sol.final_exit_reason() == "Below min. SOC", "path 13(a): wrong exit")
    check(abs(t_end - 3600.0) <= 1.0, f"path 13(a): exit at {t_end} s")
    check(abs(t_end - fast3[0]) <= 1e-10 * fast3[0], "path 13(a): t_end off the fast route")
    check(abs(V_end - fast3[1]) <= 1e-8 * fast3[1], "path 13(a): V_end off the fast route")
    check(by_n.get(71, 0) > 0, "path 13(a) never launched K1")
    n71 = by_n.get(71, 0)

    p = mp.model(device="cuda")
    n101 = 0
    for label, go in (
            ("path 13(b) batch_simulate(fast_solver=False)",
             lambda: mp.run(p, seed=0, n_cells=mp.DENSE_B, fast_solver=False)),
            ("path 13(c) run_once(linear_solver=make_schur_solver)",
             lambda: mp.run_solver(p, 0, linear_solver=make_schur_solver(p.layout))),
            ("path 13(d) run_once(jac_plan=get_plan(use_schur=False))",
             lambda: mp.run_solver(p, 0, jac_plan=get_plan(p.cfg, p.theta_floats(),
                                                            use_schur=False)))):
        torch.cuda.reset_peak_memory_stats()
        drive_path(mp, p, label, None, oracle, mp.DENSE_B, ("gj_inverse",), go=go)
        by_n = dict(gk.LAUNCHES_BY_N["gj_inverse"])
        print(f"  K1 by n {by_n}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")
        n71 += by_n.get(71, 0)
        if "(c)" in label:
            n101 = by_n.get(101, 0)
            check(n101 > 0, "path 13(c) never launched K1 at n = 101")
    return n71, n101


def phase_k1_core101(cores):
    """K1 at path 13(c)'s 101-state particle-Schur core in float32, the
    T = 16, P = 8 tile: random equilibrated matrices at (1024, 101) against
    the plain blocked version and the mirror (2e-4) and a float64 inverse
    (1e-5 of the scale); the inverses of a subset of those matrices equal
    the same rows of the whole batch's, bit for bit; the real equilibrated
    cores (8 states tiled to 1024) in float32 as close to float64 as the
    plain versions (4× plus 1e-5), in float64 against the mirror (1e-8);
    the time at (1024, 101) and (64, 101) over rotating inputs behind the
    spin, beside the bound, the plain version and torch.linalg.inv_ex; and
    the tile's registers and spills from ptxas."""
    import torch
    from petlion_tpu_torch.ops import gj_kernel as gk
    n = 101
    A = _equilibrated_inputs(1024, n, torch.float32, seed=101)
    X = gk.gj_inverse_cuda(A)
    err = float((X - gk.gj_inverse_blocked(A, bs=gk._best_bs(n))).abs().max())
    err_m = float((X - gk.gj_inverse_inplace(A)).abs().max())
    X64 = torch.linalg.inv(A.double())
    err_64 = float(((X.double() - X64).abs() / X64.abs().amax(dim=(-2, -1), keepdim=True)).max())
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    resid = float((A.double() @ X.double() - eye).abs().amax(dim=(-2, -1)).max())
    idx = torch.arange(5, 1024, 7, device="cuda")
    same = bool(torch.equal(gk.gj_inverse_cuda(A[idx].contiguous()), X[idx]))
    print(f"K1 f32 (1024, {n}) random: max|kernel - plain| = {err:.3e}, max|kernel - mirror| "
          f"= {err_m:.3e}, vs the float64 inverse / scale {err_64:.3e}, max ||AX - I||inf = "
          f"{resid:.3e}; a subset of {len(idx)} matrices inverted alone equals the same rows "
          f"of the batch's inverse bit for bit: {same}")
    check(err <= 2e-4 and err_m <= 2e-4, f"K1 disagrees with plain at (1024, {n})")
    check(err_64 <= 1e-5 and resid < 1e-3, f"K1 inverse off at (1024, {n})")
    check(same, "K1's inverse of a matrix depends on the batch around it")

    shape, e = _k1_real_cores(cores, 128)
    print(f"K1 real particle-Schur cores {shape}: f32 error vs f64 / scale: kernel "
          f"{e['kernel']:.3e}, mirror {e['mirror']:.3e}, blocked bs=8 {e['b8']:.3e}, "
          f"plain (bs={gk._best_bs(n)}) {e['best']:.3e}; f64 kernel vs mirror {e['f64']:.3e}")
    check(e["kernel"] <= 4 * e["mirror"] + 1e-5 and e["kernel"] <= 4 * e["best"] + 1e-5,
          f"K1 less accurate than plain on the real 101-state cores: {e['kernel']}")
    check(e["f64"] <= 1e-8, f"K1 float64 disagrees on the real 101-state cores: {e['f64']}")

    shapes = []
    for B, rot in ((1024, ROTATING), (64, 32)):     # 4 × 41.8 MB; 32 × 2.6 MB
        shapes.append(dict(shape=[B, n, n], **_k1_timing(B, n, rot, seed=1010 + B)))
    regs, spill = _ptxas_instance(gk.BUILD_LOGS.get("gj_inverse", ""),
                                  "gj_inverse_kernelIfLi16ELi8E")
    print(f"K1 tile T = 16, P = 8 (float), which n = {n} takes: {regs} registers, spill "
          f"stores/loads {spill} bytes")
    record = dict(max_abs_err=err, registers=regs,
                  spill_bytes=None if spill is None else list(spill), shapes=shapes)
    record.update(shapes[0])
    return record


def phase_protocol(card):
    """Path 8: the JAX suite's 2_cc_cv_protocol, 1024 LCO cells through CC
    (2C to V_max 4.1 V) then CV (V held to SOC 1) in float32 on the default
    route: every cell leaves CC at V_max (flag 2) and CV at SOC_max (flag
    4), its final SOC within 2e-3 of 1, K1 launched at n = 71; the spread of
    switch times. Returns the K1
    launches of the first run."""
    import numpy as np
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver import run as runner

    p = mp.model(device="cuda")

    def checked(results, name):
        cc, cv = results
        f_cc, f_cv = cc.flag.cpu().numpy(), cv.flag.cpu().numpy()
        soc = cv.soc_final.cpu().double().numpy()
        check(bool((f_cc == 2).all()), f"{name}: CC flags {sorted(set(f_cc.tolist()))}")
        check(bool((f_cv == 4).all()), f"{name}: CV flags {sorted(set(f_cv.tolist()))}")
        check(float(np.abs(soc - 1.0).max()) <= 2e-3, f"{name}: final SOC off 1")
        check(bool(np.isfinite(cv.y_final.cpu().numpy()).all()), f"{name}: non-finite states")
        return cc, cv, soc

    gk.reset_launch_counts()
    runner.reset_trip_counts()
    results, wall = mp.run_protocol(p, seed=0)
    launches = gk.LAUNCHES["gj_inverse"]
    by_n = dict(sorted(gk.LAUNCHES_BY_N["gj_inverse"].items()))
    trips = runner.TRIPS["trips"]
    cc, cv, soc = checked(results, "path 8")
    t_sw = cc.t_final.cpu().double().numpy()
    att = [(r.n_steps + r.n_rejected).cpu().numpy().astype(float) for r in results]
    print(f"path 8 (first run, includes plan build): {wall:.3f} s for {mp.B_MAIN} cells, "
          f"{launches} K1 launches (by n {by_n}), {trips} trips; CC exits all V_max, CV "
          f"exits all SOC_max; switch times {t_sw.min():.2f}-{t_sw.max():.2f} s (std "
          f"{t_sw.std():.4f} s); final SOC max |1 - SOC| {np.abs(soc - 1).max():.2e}; "
          f"attempts/cell CC {att[0].mean():.2f}, CV {att[1].mean():.2f}")
    check(by_n.get(71, 0) > 0, "path 8 never launched K1 at n = 71")
    return launches


def phase_thermal(card):
    """Path 9: the JAX suite's 3_thermal_cc_ct_cv, one thermal LCO cell
    through CC (4C to T_max 313.15 K), CT (the mean temperature held to
    V_max 4.1 V) and CV (V held to SOC 1) via `simulate_protocol`. Float32
    (abstol 5e-4, reltol 1e-3, the refined pivoted LU): the three exits, t
    within 1% of the reference's 1865.61 s, I within 6% of 0.1959C, the
    final T in kelvin in (290, 330) K. Float64 (the model's tolerances, K1
    at the 121-state core): t within 0.5%, I within 2.5%, V within 1e-3 of
    4.1 V, the thickness-weighted mean T within 0.1 K of 298.846 K, V equal
    to the CPU's run to 1e-9 V, and the full-kernel route's run (K2 groups,
    K3 chain on the 121 core) within twice the CPU's own gap between the two
    routes of the CPU's full-kernel run, the two routes' gap printed on both
    devices. Returns (K1 launches at
    n = 121 of the float64 run, the float32 run's LU factorizations)."""
    import numpy as np
    import torch
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.sim import _mean_T_host
    from petlion_tpu_torch.solver import linsolve

    exits = ["Above max. temperature", "Above max. voltage", "Above max. SOC"]

    def summary(sol):
        return (f"exits {sol.exit_reasons()}, segment ends "
                f"{[round(r.tspan[1], 3) for r in sol.results]} s, t_end "
                f"{float(sol.t[-1]):.3f} s, I_final {float(sol.I[-1]):.5f}C, V "
                f"{float(sol.V[-1]):.6f} V, SOC {float(sol.SOC[-1]):.6f}; steps "
                f"{[r.n_steps for r in sol.results]}, rejected "
                f"{[r.n_rejected for r in sol.results]}")

    def check32(sol, name):
        t_end, I_end = float(sol.t[-1]), float(sol.I[-1])
        T = sol.Y_final[sol_layout.sl("T")]
        check(sol.exit_reasons() == exits, f"{name}: exits {sol.exit_reasons()}")
        check(abs(t_end - 1865.61) / 1865.61 < 0.01, f"{name}: t_end {t_end}")
        check(abs(I_end - 0.1959) / 0.1959 < 0.06, f"{name}: I_final {I_end}")
        check(bool(((T > 290.0) & (T < 330.0)).all()), f"{name}: final T {T.min()}-{T.max()} K")

    p32 = mp.thermal_model(dtype=torch.float32)
    sol_layout = p32.layout
    gk.reset_launch_counts()
    linsolve.LU_FACTORS[0] = 0
    s32, wall = mp.run_thermal(p32)
    lu32 = linsolve.LU_FACTORS[0]
    k1_32 = gk.LAUNCHES["gj_inverse"]
    print(f"path 9 float32 (first run, includes plan build): {wall:.3f} s, {summary(s32)}; "
          f"{lu32} pivoted LU factorizations, {k1_32} K1 launches")
    check32(s32, "path 9 float32")
    check(lu32 > 0, "path 9 float32 never took the pivoted LU")

    p64 = mp.thermal_model(dtype=torch.float64)
    gk.reset_launch_counts()
    linsolve.LU_FACTORS[0] = 0
    s64, wall = mp.run_thermal(p64)
    by_n = dict(sorted(gk.LAUNCHES_BY_N["gj_inverse"].items()))
    Tm = _mean_T_host(s64.Y_final, p64)
    print(f"path 9 float64 (first run): {wall:.3f} s, {summary(s64)}; mean T "
          f"{Tm:.5f} K; K1 launches by n {by_n}, {linsolve.LU_FACTORS[0]} LU")
    check(s64.exit_reasons() == exits, f"path 9 float64: exits {s64.exit_reasons()}")
    check(abs(float(s64.t[-1]) - 1865.61) / 1865.61 < 0.005, "path 9 float64: t_end")
    check(abs(float(s64.I[-1]) - 0.1959) / 0.1959 < 0.025, "path 9 float64: I_final")
    check(abs(float(s64.V[-1]) - 4.1) < 1e-3, "path 9 float64: V_final")
    check(abs(Tm - 298.846) < 0.1, f"path 9 float64: mean T {Tm}")
    check(by_n.get(121, 0) > 0 and by_n.get(71, 0) > 0,
          "path 9 float64 never launched K1 at the 121-state core and the init block")

    # card = CPU, as |dV| in volts: the default route (K1) to 1e-9 V. The
    # full-kernel route is held to twice the gap between the two routes'
    # plain versions on the CPU, this flow's sensitivity to the order of
    # the arithmetic: two elimination orders of the dT-hold core (cond near
    # 1e16) part by 1.128e-9 V there, and the card's K2/K3 lay 1.47e-9 V
    # from their plain versions (ROADMAP C)
    def max_dv(a, b):
        return (float(np.abs(a.V - b.V).max()) if len(a.V) == len(b.V) else float("inf"))

    cpu = mp.thermal_model(device="cpu", dtype=torch.float64)
    s_cpu = mp.run_thermal(cpu)[0]
    dv = max_dv(s64, s_cpu)
    print(f"path 9 float64 card against the CPU: max |dV| {dv:.3e} V, steps "
          f"{[r.n_steps for r in s_cpu.results]} on the CPU")
    check(dv <= 1e-9, f"path 9 float64: card and CPU {dv} V apart")

    gk.reset_launch_counts()
    s_fk, w_fk = mp.run_thermal(p64, route=mp.PATH2)
    fk = {k: dict(sorted(v.items())) for k, v in gk.LAUNCHES_BY_N.items()}
    s_fk_cpu = mp.run_thermal(cpu, route=mp.PATH2)[0]
    dv_fk, order_gap = max_dv(s_fk, s_fk_cpu), max_dv(s_fk_cpu, s_cpu)
    print(f"path 9 float64, full-kernel route: {w_fk:.3f} s, {summary(s_fk)}; launches by n "
          f"{fk}; max |dV| against the CPU's full-kernel route {dv_fk:.3e} V; between the "
          f"two routes {max_dv(s_fk, s64):.3e} V on the card, {order_gap:.3e} V on the CPU")
    check(fk["gj_blocks"] and fk["dchain"].get(121, 0) > 0,
          "path 9's full-kernel route did not run K2 and K3 at the 121 core")
    check(dv_fk <= 2.0 * order_gap,
          f"path 9 full-kernel route: card and CPU {dv_fk} V apart, the CPU's two routes "
          f"{order_gap} V")
    return by_n.get(121, 0), lu32


def phase_thermal_batched(card):
    """Path 10, its first chunk: 128 thermal LCO cells in float32, 250 s of
    a 1C discharge from SOC 1 through the refined pivoted LU: every cell's
    flag in {0, 1, 3}, finite states; attempts per cell, the wall and the
    LU factorizations."""
    import numpy as np
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver import linsolve
    from petlion_tpu_torch.solver import run as runner

    p = mp.thermal_model()
    gk.reset_launch_counts()
    runner.reset_trip_counts()
    linsolve.LU_FACTORS[0] = 0
    results, wall = mp.run_thermal_batched(p, seed=0, chunks=1)
    r = results[0]
    flags = r.flag.cpu().numpy()
    att = (r.n_steps + r.n_rejected).cpu().numpy().astype(float)
    lu = linsolve.LU_FACTORS[0]
    print(f"path 10, chunk 1 of {mp.THERMAL_CHUNKS} ({mp.THERMAL_CHUNK_TF:g} s): {wall:.3f} s "
          f"for {mp.THERMAL_B} cells (includes plan build), flags "
          f"{dict(zip(*np.unique(flags, return_counts=True)))}; attempts/cell mean "
          f"{att.mean():.2f} max {att.max():.0f}; {runner.TRIPS['trips']} trips, {lu} pivoted "
          f"LU factorizations, {gk.LAUNCHES['gj_inverse']} K1 launches [{card}]")
    check(bool(np.isin(flags, (0, 1, 3)).all()), f"path 10: flags {sorted(set(flags.tolist()))}")
    check(bool(np.isfinite(r.y_final.cpu().numpy()).all()), "path 10: non-finite states")
    check(lu > 0, "path 10 never took the pivoted LU")
    return lu


# the tangent kernels (forward-mode parameter estimation, path 14)
TANGENT_KERNELS = ("gj_tangent", "dchain_tangent")


def guard_tangent_launches():
    """From here on every reset of the launch counts checks that no tangent
    kernel launched since the last one: paths 1-13 and 15 take no tangent.
    Returns a function that lifts the check (for path 14)."""
    from petlion_tpu_torch.ops import gj_kernel as gk
    reset = gk.reset_launch_counts
    state = {"on": True}

    def checked_reset():
        stray = {k: gk.LAUNCHES[k] for k in TANGENT_KERNELS if gk.LAUNCHES[k]}
        check(not (state["on"] and stray), f"a plain path launched tangent kernels: {stray}")
        reset()

    gk.reset_launch_counts = checked_reset
    return lambda: state.update(on=False)


def _scaled(got, ref):
    return float((got.double() - ref).abs().max()) / float(ref.abs().max())


# K1ᵗ's and K3ᵗ's times in their first design as PERF.md §6 records them
# (the same card and script, an earlier run), printed beside each new time
# for the reader and kept out of the kernels line: {(B, n, dtype): ms}
K1T_BEFORE_MS = {(1, 71, "float64"): 0.0684, (2, 71, "float64"): 0.0679,
               (1024, 71, "float32"): 0.2087, (10240, 10, "float32"): 0.0291,
               (10240, 10, "float64"): 0.0393, (1024, 30, "float32"): 0.0218,
               (1024, 30, "float64"): 0.0306}
K3T_BEFORE_MS = {(1, "float64"): 0.0537, (1024, "float64"): 0.5354, (1024, "float32"): 0.1745}


def _print_ptxas(name):
    """Print, and return, the registers and spills of every instance of a
    kernel library (the template arguments of its mangled names)."""
    import re
    from petlion_tpu_torch.ops import gj_kernel as gk
    rows = []
    for inst, regs, st, ld, _ in gk.ptxas_report(gk.BUILD_LOGS.get(name, "")):
        m = re.search(r"kernelI(\w+?)E+vP", inst)
        rows.append(dict(instance=m.group(1) if m else inst, registers=regs,
                         spill_bytes=[st, ld]))
    print(f"{name} instances (registers, spill stores/loads B): " + "; ".join(
        f"{r['instance']}: {r['registers']}, {r['spill_bytes'][0]}/{r['spill_bytes'][1]}"
        for r in rows))
    return rows


def _before(ms, before):
    return ("not recorded" if before is None
            else f"{before:.4f} ms in PERF.md ({before / ms:.2f}x now)")


def phase_k1t():
    """K1ᵗ (csrc/gj_tangent.cu, dX = −X·dA·X) against its plain version at
    (B, n) = (1, 71), (2, 71), (10, 10) and (1, 30) in float64 (path 14's
    shapes: one cell a fitted parameter, its 71-state core, or on the
    full-kernel route its 10 particle blocks and c_e block), (1024, 71) in
    float32, (10240, 10) and (1024, 30) in float32 and float64 (K2's
    tangent), on equilibrated random matrices and their inverses: in
    float64 within 1e-10 of the tangent's scale; in float32 its error
    against float64 at most 4× the plain float32 version's plus 1e-5. Each
    shape timed over rotating inputs behind the spin, beside its first design's time,
    its bound, the plain version and a yardstick of two torch.bmm calls
    (−(X·dA)·X, which the port never calls), with its launch plan (held to
    the compiled source's) and the host µs a call; then the registers and
    spills of every instance."""
    import numpy as np
    import torch
    from petlion_tpu_torch.ops import cost, gj_kernel as gk
    cases = (((1, 71), torch.float64), ((2, 71), torch.float64), ((10, 10), torch.float64),
             ((1, 30), torch.float64), ((1024, 71), torch.float32),
             ((10240, 10), torch.float32), ((10240, 10), torch.float64),
             ((1024, 30), torch.float32), ((1024, 30), torch.float64))
    shapes, worst = [], 0.0
    for (B, n), dtype in cases:
        A = _equilibrated_inputs(B, n, torch.float64, seed=B * 100 + n)
        X = torch.linalg.inv(A).contiguous()
        dA = torch.as_tensor(np.random.default_rng(B + n).standard_normal((B, n, n)),
                             device="cuda")
        ref = gk.gj_tangent_plain(X, dA)
        got = gk.gj_tangent_cuda(X.to(dtype), dA.to(dtype))
        err = _scaled(got, ref)
        if dtype == torch.float64:
            plain_err = None
            check(err <= 1e-10, f"K1t f64 ({B}, {n}) off its plain version: {err}")
        else:
            plain_err = _scaled(gk.gj_tangent_plain(X.float(), dA.float()), ref)
            check(err <= 4 * plain_err + 1e-5, f"K1t f32 ({B}, {n}): {err} vs plain {plain_err}")
        worst = max(worst, float((got - gk.gj_tangent_plain(X.to(dtype), dA.to(dtype)))
                                 .abs().max()))
        plan = gk.gj_tangent_plan(B, n, dtype)
        compiled = gk.gj_tangent_block(plan, dtype)
        check(compiled == (plan.smem, plan.threads),
              f"K1t plan {plan} disagrees with the compiled instance {compiled}")
        size = torch.empty(0, dtype=dtype).element_size()
        rot = max(4, -(-60_000_000 // (2 * B * n * n * size)))
        bufs = [(X.to(dtype), (dA * (1 + i)).to(dtype)) for i in range(min(rot, 64))]
        ms, host_us = device_ms(lambda a: gk.gj_tangent_cuda(*a), bufs, reps=200)
        plain_ms, _ = device_ms(lambda a: gk.gj_tangent_plain(*a), bufs, reps=20, spin=False)
        bmm_ms, _ = device_ms(lambda a: torch.bmm(torch.bmm(a[0], a[1]), a[0]), bufs, reps=20)
        bound_ms, by = cost.bound(*reversed(cost.gj_tangent(B, n, size)),
                                  fp64=dtype == torch.float64)
        tag = str(dtype)[6:]
        before = K1T_BEFORE_MS.get((B, n, tag))
        print(f"K1t {tag} ({B}, {n}) [{plan.regime}: np {plan.np}, panels of {plan.panel} rows, "
              f"{plan.mb} a block, {plan.blocks} blocks of {plan.threads}, {plan.smem} B]: "
              f"error vs float64 plain / scale {err:.3e}"
              f"{'' if plain_err is None else f' (plain f32 {plain_err:.3e})'}; kernel "
              f"{ms:.4f} ms (first design: {_before(ms, before)}), two torch.bmm {bmm_ms:.4f} ms "
              f"({'kernel faster' if ms <= bmm_ms else 'KERNEL SLOWER'}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of it "
              f"reached); host {host_us:.1f} us per call")
        shapes.append(dict(shape=[B, n, n], dtype=tag, regime=plan.regime, ms=ms,
                           plain_ms=plain_ms, bmm_ms=bmm_ms, library_ms=None,
                           bound_ms=bound_ms, bound_by=by, host_us=host_us))
    slower = [s_["shape"][:2] + [s_["dtype"]] for s_ in shapes if s_["ms"] > s_["bmm_ms"]]
    print(f"K1t against two torch.bmm: slower at {slower or 'no shape'}")
    instances = _print_ptxas("gj_tangent")
    first = shapes[0]
    return dict(max_abs_err=worst, **{k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                                            "bound_ms", "bound_by")},
                bmm_ms=first["bmm_ms"], shape=first["shape"], shapes=shapes,
                instances=instances)


def phase_k3t(Dp, sizes):
    """K3ᵗ (csrc/dchain_tangent.cu) on the permuted Schur cores of real
    Newton matrices (the cores phase_k3 takes, levels (20, 20)) with K3's
    outputs and a tangent of the cores' pattern (a numpy seed), at B = 1
    (path 14's shape), 5 and 1024 cells: in float64 every output's tangent
    within 1e-10 of its scale from the plain version's, in float32 as close
    to the float64 tangent as the plain float32 version (4× plus 1e-5). The
    time at (1, 71) float64 and (1024, 71) float32 and float64, beside its
    first design's, the bound, the plain version and two torch.bmm at the core's size,
    with the host µs a call and the shared memory a block (held to the
    compiled source's) and blocks an SM; the registers and spills of both
    instances."""
    import numpy as np
    import torch
    from petlion_tpu_torch.ops import cost, dchain as kd
    worst = 0.0
    rng = np.random.default_rng(5)
    dDp = Dp * torch.as_tensor(rng.standard_normal(Dp.shape))
    for B in (1, 5, 1024):
        reps = -(-B // Dp.shape[0])
        D = Dp.to("cuda").repeat(reps, 1, 1)[:B].contiguous()
        dD = dDp.to("cuda").repeat(reps, 1, 1)[:B].contiguous()
        ref = kd.dchain_tangent_plain(D, dD, kd.dchain_plain(D, sizes), sizes)
        for dtype in (torch.float64, torch.float32):
            Dt, dDt = D.to(dtype), dD.to(dtype)
            got = kd.dchain_tangent_cuda(Dt, dDt, kd.dchain_cuda(Dt, sizes), sizes)
            plain = kd.dchain_tangent_plain(Dt, dDt, kd.dchain_plain(Dt, sizes), sizes)
            errs = [_scaled(g, r) for g, r in zip(got, ref)]
            perrs = [_scaled(q, r) for q, r in zip(plain, ref)]
            for i, (e, pe) in enumerate(zip(errs, perrs)):
                if dtype == torch.float64:
                    check(e <= 1e-10, f"K3t f64 B={B} output {i}: {e}")
                else:
                    check(e <= 4 * pe + 1e-5, f"K3t f32 B={B} output {i}: {e} vs plain {pe}")
            if dtype == torch.float64:
                worst = max(worst, max(float((g - q).abs().max()) for g, q in zip(got, plain)))
            print(f"K3t {str(dtype)[6:]} B={B}: tangent error / scale per output "
                  f"{', '.join(f'{e:.2e}' for e in errs)}"
                  + ("" if dtype == torch.float64 else
                     f" (plain f32 {', '.join(f'{e:.2e}' for e in perrs)})"))
    n = Dp.shape[-1]
    shapes = []
    for B, dtype in ((1, torch.float64), (1024, torch.float64), (1024, torch.float32)):
        size = torch.empty(0, dtype=dtype).element_size()
        smem = kd.tangent_smem_bytes(n, sizes, dtype)
        check(kd.dchain_tangent_smem_compiled(n, sizes, dtype) == smem,
              f"K3t shared memory of the plan ({smem} B) is not the compiled source's")
        reps = -(-B // Dp.shape[0])
        rot = 64 if B == 1 else ROTATING
        bufs = []
        for i in range(rot):
            D = Dp.to("cuda", dtype).repeat(reps, 1, 1)[:B].contiguous()
            dD = (dDp * (1 + i)).to("cuda", dtype).repeat(reps, 1, 1)[:B].contiguous()
            bufs.append((D, dD, kd.dchain_cuda(D, sizes)))
        ms, host_us = device_ms(lambda a: kd.dchain_tangent_cuda(*a, sizes), bufs, reps=200)
        plain_ms, _ = device_ms(lambda a: kd.dchain_tangent_plain(*a, sizes), bufs, reps=8,
                                spin=False)
        bmm_ms, _ = device_ms(lambda a: torch.bmm(torch.bmm(a[0], a[1]), a[0]), bufs, reps=20)
        flops, n_bytes = cost.dchain_tangent(B, n, sizes, size)
        bound_ms, by = cost.bound(n_bytes, flops, fp64=dtype == torch.float64)
        tag = str(dtype)[6:]
        before = K3T_BEFORE_MS.get((B, tag))
        print(f"K3t timing ({B}, {n}, {n}) sizes {tuple(sizes)} {tag}, {rot} rotating inputs, "
              f"{smem} B a block, {kd.tangent_blocks_per_sm(n, sizes, dtype)} blocks an SM: "
              f"kernel {ms:.4f} ms (first design: {_before(ms, before)}), plain {plain_ms:.4f} ms, two "
              f"torch.bmm at ({B}, {n}, {n}) {bmm_ms:.4f} ms, no single PyTorch call computes "
              f"the tangent; bound {bound_ms:.4f} ms ({by}: {n_bytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP; {bound_ms / ms:.1%} of it reached); host "
              f"{host_us:.1f} us per call")
        shapes.append(dict(shape=[B, n, n], dtype=tag, sizes=list(sizes), ms=ms,
                           plain_ms=plain_ms, bmm_ms=bmm_ms, library_ms=None,
                           bound_ms=bound_ms, bound_by=by, host_us=host_us, smem_bytes=smem))
    instances = _print_ptxas("dchain_tangent")
    first = shapes[0]
    return dict(max_abs_err=worst, **{k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                                            "bound_ms", "bound_by")},
                bmm_ms=first["bmm_ms"], shape=first["shape"], shapes=shapes,
                instances=instances)


def _sens_run(p, route=None):
    """Path 14's sensitivities (the JAX package's tests/test_estimation.py:18)
    on `p`'s device, with the launch and trip counts set to 0 just before and
    read just after: (J, θ0, wall, launches by kernel and n, trips)."""
    import numpy as np
    import torch
    from petlion_tpu_torch import estimation as est
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver import run as runner
    gk.reset_launch_counts()
    runner.reset_trip_counts()
    t0 = time.time()
    J, th0 = est.sensitivities(p, ["D_sp"], np.array([100.0, 300.0, 550.0]), I_crate=-1.0,
                               SOC=0.5, route=route)
    if p.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: dict(v) for k, v in gk.LAUNCHES_BY_N.items() if v}
    return J, th0, wall, launches, runner.TRIPS["trips"]


def phase_estimation(card):
    """Path 14, parameter estimation in float64 (see the module docstring).
    Returns the tangent kernels' launches over the path, by kernel."""
    import numpy as np
    import torch
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import estimation as est
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE
    from petlion_tpu_torch.solver import run as runner

    p = ptt.petlion(ptt.LCO, device="cuda")
    launched = {k: 0 for k in TANGENT_KERNELS}
    # (a) the default route: K1 and K1ᵗ at n = 71
    J, th0, wall_a, la, trips_a = _sens_run(p)
    print(f"path 14(a) sensitivities, default route: dV/dD_sp at 100, 300, 550 s = "
          f"{', '.join(f'{x:.10e}' for x in J[:, 0])}; {wall_a:.3f} s cold, {trips_a} trips; "
          f"launches by n {la} [{card}]")
    check(la.get("gj_tangent", {}).get(71, 0) > 0, "path 14(a) never launched K1t at n = 71")
    check(not la.get("dchain_tangent"), "path 14(a) launched K3t on the default route")
    for k in TANGENT_KERNELS:
        launched[k] += sum(la.get(k, {}).values())
    voltage, _ = est.make_voltage_model(p, ["D_sp"], t_eval=np.array([100.0, 300.0, 550.0]),
                                        I_crate=-1.0, SOC=0.5)
    th = torch.as_tensor(th0, dtype=torch.float64, device="cuda")
    eps = 1e-18
    t0 = time.time()
    Vpm = voltage(torch.stack([th + eps, th - eps]))
    torch.cuda.synchronize()
    fd = ((Vpm[0] - Vpm[1]) / (2 * eps)).cpu().numpy()
    fd_err = float(np.max(np.abs(J[:, 0] - fd) / np.abs(fd)))
    print(f"  central difference on the card (eps 1e-18, one run of two cells, "
          f"{time.time() - t0:.3f} s): {', '.join(f'{x:.10e}' for x in fd)}; max rel "
          f"{fd_err:.3e} (rtol 1e-5)")
    check(fd_err <= 1e-5, f"path 14(a) off the central difference: {fd_err}")
    J_cpu, _, wall_cpu, _, trips_cpu = _sens_run(ptt.petlion(ptt.LCO, device="cpu"))
    cpu_err = float(np.max(np.abs(J - J_cpu) / np.abs(J_cpu)))
    print(f"  the same on the CPU: {wall_cpu:.3f} s, {trips_cpu} trips; card vs CPU max rel "
          f"{cpu_err:.3e} (rtol 1e-8)")
    check(cpu_err <= 1e-8, f"path 14(a): card off the CPU by {cpu_err}")

    # (b) the full-kernel route: K2, K3 and their tangents K1ᵗ (n = 10, 30), K3ᵗ
    Jb, _, wall_b, lb, trips_b = _sens_run(p, FULL_KERNEL_ROUTE)
    b_err = float(np.max(np.abs(Jb - J) / np.abs(J)))
    print(f"path 14(b) sensitivities, full-kernel route: {wall_b:.3f} s cold, {trips_b} trips; "
          f"vs (a) max rel {b_err:.3e} (rtol 1e-7); launches by n {lb} [{card}]")
    for n in (10, 30):
        check(lb.get("gj_tangent", {}).get(n, 0) > 0, f"path 14(b) never launched K1t at n = {n}")
    check(sum(lb.get("dchain_tangent", {}).values()) > 0, "path 14(b) never launched K3t")
    check(b_err <= 1e-7, f"path 14(b) off (a) by {b_err}")
    for k in TANGENT_KERNELS:
        launched[k] += sum(lb.get(k, {}).values())

    # (c) the JAX package's Gauss-Newton recovery (tests/test_estimation.py:31)
    true = {"D_sp": 1.7e-14, "k_n": 3.1e-11}
    t_data = np.linspace(60.0, 1700.0, 24)
    pc = ptt.petlion(ptt.LCO, device="cuda")
    for k, v in true.items():
        pc.theta[k] = torch.tensor(v, dtype=torch.float64, device="cuda")
    voltage, th_true = est.make_voltage_model(pc, list(true), t_eval=t_data, I_crate=-1.0,
                                              SOC=0.9)
    t0 = time.time()
    V_data = voltage(th_true).cpu().numpy()
    wall_data = time.time() - t0
    pc.theta["D_sp"] = torch.tensor(1e-14, dtype=torch.float64, device="cuda")
    pc.theta["k_n"] = torch.tensor(5.031e-11, dtype=torch.float64, device="cuda")
    gk.reset_launch_counts()
    runner.reset_trip_counts()
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):    # verbose prints each iteration's rms
        fitted = est.fit(pc, list(true), t_data, V_data, I_crate=-1.0, SOC=0.9, iters=GN_ITERS,
                         verbose=True)
    torch.cuda.synchronize()
    wall_c = time.time() - t0
    rms = [line.split("rms=")[1] for line in out.getvalue().splitlines() if "rms=" in line]
    lc = {k: dict(v) for k, v in gk.LAUNCHES_BY_N.items() if v}
    errs = {k: abs(fitted[k] - v) / v for k, v in true.items()}
    print(f"path 14(c) Gauss-Newton fit: data {wall_data:.3f} s; fit {wall_c:.3f} s, "
          f"{len(rms)} iterations, {runner.TRIPS['trips']} trips; rms per iteration "
          f"{', '.join(rms)}; fitted {fitted}; relative errors "
          f"{errs}; launches by n {lc} [{card}]")
    for k, e in errs.items():
        check(e < 1e-3, f"path 14(c): {k} fitted {fitted[k]}, off by {e}")
    check(lc.get("gj_tangent", {}).get(71, 0) > 0, "path 14(c) never launched K1t at n = 71")
    for k in TANGENT_KERNELS:
        launched[k] += sum(lc.get(k, {}).values())
    print(f"path 14 walls: (a) {wall_a:.3f} s; (b) {wall_b:.3f} s; "
          f"(c) {wall_c:.3f} s for {len(rms)} iterations; tangent launches {launched}")
    return launched


def phase_mesh(card, oracle):
    """Path 15(a), the cells axis split over devices (see the module
    docstring). Returns K1's launches over the phase."""
    import numpy as np
    import torch
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver import run as runner

    p = mp.model(device="cuda")
    mesh = ptt.make_cell_mesh()
    print(f"path 15(a) mesh {[str(d) for d in mesh.devices]}, axis {mesh.axis_name!r}")
    launches, _ = drive_path(mp, p, "path 15(a) path 1 through make_cell_mesh()", mp.PATH1,
                             oracle, mp.B_MAIN, ("gj_inverse",),
                             go=lambda: mp.run(p, seed=0, route=mp.PATH1, mesh=mesh))
    k1 = launches["gj_inverse"]

    # MESH_B float64 cells split over two shards of the one card, against the
    # same cells unsplit
    tb = {k: v[:MESH_B] for k, v in mp.theta_batch(0).items()}
    kw = dict(I=-1.0, SOC=1.0, theta_batch=tb, outputs=("t", "V"), route=mp.PATH1,
              dtype=torch.float64)

    def counted(**extra):
        gk.reset_launch_counts()
        runner.reset_trip_counts()
        t0 = time.perf_counter()
        r = ptt.batch_simulate(p, mp.TF, **kw, **extra)
        torch.cuda.synchronize()
        return r, gk.LAUNCHES["gj_inverse"], runner.TRIPS["trips"], time.perf_counter() - t0

    ref, k1_ref, trips_ref, wall_ref = counted()
    two = ptt.make_cell_mesh(devices=["cuda:0", "cuda:0"])
    got, k1_split, trips_split, wall_split = counted(mesh=two)
    t_err = float(np.max(np.abs(got.t_final.cpu().numpy() - ref.t_final.cpu().numpy())
                         / np.abs(ref.t_final.cpu().numpy())))
    y_ref = ref.y_final.cpu().numpy()
    y_err = float(np.max(np.abs(got.y_final.cpu().numpy() - y_ref)
                         / np.maximum(np.abs(y_ref), 1e-300)))
    # a trip makes one attempt for each cell still running, so a run's trips
    # are its slowest cell's attempts, and each shard's its own slowest
    # cell's; K1 launches once a trip and, in the initialization, as often
    # in a shard as in the whole batch (its cells converge together)
    att = (ref.n_steps + ref.n_rejected).cpu().numpy()
    shard_trips = [int(a.max()) for a in np.split(att, two.size)]
    k1_init = k1_ref - trips_ref
    print(f"path 15(a) {MESH_B} float64 cells over {[str(d) for d in two.devices]}: "
          f"{wall_split:.3f} s, {trips_split} trips, K1 {k1_split}; unsplit {wall_ref:.3f} s, "
          f"{trips_ref} trips, K1 {k1_ref} ({k1_init} in the initialization); the shards' "
          f"slowest cells take {shard_trips} attempts; split vs unsplit max rel t_final "
          f"{t_err:.3e} (rtol 1e-12), y_final {y_err:.3e} (rtol 1e-8) [{card}]")
    check(bool(np.isin(got.flag.cpu().numpy(), (0, 1, 3)).all()), "path 15(a) split: bad flags")
    check(bool((got.flag == ref.flag).all()), "path 15(a): split flags differ from unsplit")
    check(got.y_final.device == torch.device("cuda", 0), "path 15(a): result off the mesh's device")
    check(t_err <= 1e-12, f"path 15(a): split t_final off the unsplit by {t_err}")
    check(y_err <= 1e-8, f"path 15(a): split y_final off the unsplit by {y_err}")
    check(trips_ref == int(att.max()), f"path 15(a): {trips_ref} trips for {att.max()} attempts")
    check(trips_split == sum(shard_trips),
          f"path 15(a): the split run's trips {trips_split} are not its shards' {shard_trips} summed")
    check(k1_split == two.size * k1_init + trips_split,
          f"path 15(a): the split run launched K1 {k1_split} times, not {two.size} × {k1_init} "
          f"+ {trips_split} (its shards' initializations and trips)")
    return k1 + k1_ref + k1_split


def phase_cost(card, trip_s):
    """Path 15(b), batch_cost_analysis (see the module docstring). Returns
    K1's launches over the phase."""
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import cost, gj_kernel as gk

    p = mp.model(device="cuda")
    gk.reset_launch_counts()
    kw = dict(I=-1.0, SOC=1.0, outputs=("t", "V"))
    for name, route in (("path 1", mp.PATH1), ("path 2", mp.PATH2)):
        t0 = time.perf_counter()
        c = ptt.batch_cost_analysis(p, mp.TF, theta_batch=mp.theta_batch(0), route=route, **kw)
        wall = time.perf_counter() - t0
        print(f"path 15(b) batch_cost_analysis of {name}, {mp.B_MAIN} float32 cells, one trip "
              f"({wall:.3f} s with the initialization): {c['flops']:.6e} flops, "
              f"{c['bytes accessed']:.6e} bytes accessed, {c['ops']} aten ops; kernels "
              f"{c['kernels']}; over the mean trip wall of path 1's warm run "
              f"{trip_s * 1e3:.2f} ms: "
              f"{c['flops'] / trip_s / 1e9:.3f} GFLOP/s ({c['flops'] / trip_s / cost.PEAK_FP32_FLOP_PER_S:.4%} "
              f"of the float32 peak), {c['bytes accessed'] / trip_s / 1e9:.3f} GB/s "
              f"({c['bytes accessed'] / trip_s / cost.PEAK_BYTES_PER_S:.4%} of HBM's) [{card}]")
        check(c["flops"] > 0 and c["bytes accessed"] > 0, f"path 15(b) {name}: empty count")
        needs = ("gj_inverse",) if route == mp.PATH1 else ("gj_blocks", "dchain")
        for k in needs:
            check(c["kernels"].get(k, {}).get("launches", 0) > 0,
                  f"path 15(b) {name}: the trip counted no {k} launch")
        tb = {k: v[:MESH_B] for k, v in mp.theta_batch(0).items()}
        both = {dev: ptt.batch_cost_analysis(p, mp.TF, theta_batch=tb, route=route,
                                             device=dev, **kw)
                for dev in ("cuda", "cpu")}
        gpu, cpu = both["cuda"], both["cpu"]
        rel = {key: abs(gpu[key] - cpu[key]) / cpu[key] for key in ("flops", "bytes accessed")}
        print(f"  at {MESH_B} cells: card {gpu['flops']:.6e} flops, {gpu['bytes accessed']:.6e} "
              f"bytes, {gpu['ops']} ops; CPU {cpu['flops']:.6e}, {cpu['bytes accessed']:.6e}, "
              f"{cpu['ops']} ops; relative gaps {rel} (at most 1%)")
        for key, r in rel.items():
            check(r <= 0.01, f"path 15(b) {name}: the card's {key} is {r:.3%} off the CPU's")
        check(gpu["kernels"] == cpu["kernels"], f"path 15(b) {name}: kernel counts differ "
              f"between the card {gpu['kernels']} and the CPU {cpu['kernels']}")
    return gk.LAUNCHES["gj_inverse"]


def _kernel_events(path, symbol):
    """(events, CUDA kernel events, kernel events whose name holds `symbol`)
    of a Chrome trace as torch.profiler writes it (each event's "cat" then
    its "name", one line or two), by a regular expression over the file: a
    run's trace holds millions of events (tests/test_torch_api_tools.py
    parses a small one as JSON)."""
    import re
    with open(path, "rb") as f:
        data = f.read()
    names = re.findall(rb'"cat":\s*"kernel",\s*"name":\s*"([^"]*)"', data)
    if not names:   # show how the trace names kernels, if it does
        at = data.find(b"kernel")
        print(f"  no kernel event matched; the trace near its first 'kernel': "
              f"{data[max(at - 300, 0):at + 300] if at >= 0 else None!r}")
    return data.count(b'"ph":'), len(names), sum(symbol.encode() in n for n in names)


def phase_profile(card):
    """Path 15(c), trace and Timer around one run (see the module docstring).
    Returns K1's launches in it."""
    import glob
    import shutil
    import numpy as np
    import petlion_tpu_torch as ptt
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.utils.profiling import Timer, trace

    p = mp.model(device="cuda")
    tb = {k: v[:MESH_B] for k, v in mp.theta_batch(0).items()}
    logdir = os.path.join(HERE, "build", "trace")
    shutil.rmtree(logdir, ignore_errors=True)
    tm = Timer()
    name = f"path 1, {MESH_B} cells"
    out = []
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    with tm.phase(name, sync=out), trace(logdir) as d:
        out.append(ptt.batch_simulate(p, mp.TF, I=-1.0, SOC=1.0, theta_batch=tb,
                                      outputs=("t", "V")))
    wall = time.perf_counter() - t0
    k1 = gk.LAUNCHES["gj_inverse"]
    report = tm.report()
    files = glob.glob(os.path.join(d, "trace_*.json"))
    check(len(files) == 1, f"path 15(c): trace wrote {files}")
    t0 = time.perf_counter()
    symbol = mp.KERNEL_SYMBOLS["gj_inverse"]
    n_events, n_kernels, n_k1 = _kernel_events(files[0], symbol)
    t_scan = time.perf_counter() - t0
    print(f"path 15(c) trace of path 1 at {MESH_B} cells: {wall:.3f} s traced and exported, "
          f"{os.path.getsize(files[0]) / 1e6:.1f} MB, scanned in {t_scan:.3f} s: {n_events} "
          f"events, {n_kernels} CUDA kernel events, {n_k1} of them {symbol} (K1 launches in the "
          f"run {k1}); Timer: {report} [{card}]")
    shutil.rmtree(logdir, ignore_errors=True)
    check(bool(np.isin(out[0].flag.cpu().numpy(), (0, 1, 3)).all()), "path 15(c): bad flags")
    check(n_k1 > 0, f"path 15(c): the trace holds no {symbol} event")
    check(report.startswith(f"{name}: best") and "over 1 calls" in report,
          f"path 15(c): Timer reported {report!r}")
    return k1


def start_path15_child(card, trip_s):
    """Start path 15(a)-(c) in a child process of this script,
    `chip_smoke.py --path15 CARD TRIP_S`, its output to build/path15.out.
    Returns ("path 15(a-c)", process, start time on the epoch clock)."""
    out = os.path.join(HERE, "build", "path15.out")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--path15", card, repr(trip_s)],
            cwd=HERE, stdout=f, stderr=subprocess.STDOUT)
    return "path 15(a-c)", proc, time.time()


def finish_path15_child(child):
    """Wait for path 15(a)-(c)'s child (PATH15_TIMEOUT from its start),
    print its output and check it exited 0. Returns its K1 launches by
    phase (its result line, a JSON object)."""
    _, proc, _ = child
    wait_for([child], PATH15_TIMEOUT)
    with open(os.path.join(HERE, "build", "path15.out")) as f:
        text = f.read()
    print(text.rstrip())
    check(proc.returncode == 0, f"path 15(a-c) exited {proc.returncode}")
    last = [line for line in text.splitlines() if line.startswith('{"k1"')]
    check(len(last) == 1, "path 15(a-c) printed no result")
    return json.loads(last[0])["k1"]


def path15_main(card, trip_s):
    """The child of start_path15_child: path 15(a)-(c) on the card, then no
    tangent launch (the parent's tangent guard does not see this process);
    prints its phase walls and {"k1": {phase: launches}} last."""
    import numpy as np
    import torch
    from petlion_tpu_torch.ops import gj_kernel as gk
    torch.backends.cuda.matmul.allow_tf32 = False
    k1 = dict(a=phase_mesh(card, np.load(ORACLE)))
    mark("path 15(a)")
    k1["b"] = phase_cost(card, trip_s)
    mark("path 15(b)")
    k1["c"] = phase_profile(card)
    mark("path 15(c)")
    stray = {k: gk.LAUNCHES[k] for k in TANGENT_KERNELS if gk.LAUNCHES[k]}
    check(not stray, f"path 15 launched tangent kernels: {stray}")
    print("path 15 phase walls: " + ", ".join(f"{name} {wall:.1f} s"
                                              for name, wall in phase_walls()))
    print(json.dumps({"k1": k1}))
    return 0


def start_examples():
    """Start path 15(d)'s examples (see the module docstring), each as
    `python -m` on the card with one host thread of torch, all at once; their
    output goes to build/examples/<name>.out and .err. Returns
    [(name, process, start time on the epoch clock)]."""
    cwd = os.path.join(HERE, "build", "examples")
    os.makedirs(cwd, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [HERE, os.environ.get("PYTHONPATH")])))
    procs = []
    for name in EXAMPLES_ON_CARD:
        with open(os.path.join(cwd, f"{name}.out"), "w") as out, \
                open(os.path.join(cwd, f"{name}.err"), "w") as err:
            procs.append((name, subprocess.Popen(
                [sys.executable, "-m", f"petlion_tpu_torch.examples.{name}", "--device", "cuda"],
                cwd=cwd, env=env, stdout=out, stderr=err), time.time()))
    return procs


def wait_for(children, timeout):
    """Wait until every child has exited; fail once one has run `timeout`
    seconds."""
    while any(proc.poll() is None for _, proc, _ in children):
        late = [n for n, proc, t0 in children
                if proc.poll() is None and time.time() - t0 > timeout]
        check(not late, f"still running after {timeout} s: {late}")
        time.sleep(0.2)


def finish_examples(card, procs):
    """Wait for the examples and check each: exit 0 and its expected line.
    An example's wall runs from its start to its last line of output (its
    output file's modification time)."""
    import torch
    count = torch.cuda.device_count()
    expect = dict(EXAMPLES_ON_CARD, multichip_sweep=f"completed {64 * count}/{64 * count}")
    wait_for(procs, EXAMPLE_TIMEOUT)
    cwd = os.path.join(HERE, "build", "examples")
    ends = {name: os.path.getmtime(os.path.join(cwd, f"{name}.out")) for name, _, _ in procs}
    t_start = min(t0 for _, _, t0 in procs)
    print(f"path 15(d) {len(procs)} examples at once on the card, beside path 14: "
          f"{max(ends.values()) - t_start:.1f} s to the last one's last line [{card}]")
    for name, proc, t0 in procs:
        with open(os.path.join(cwd, f"{name}.out")) as f:
            out = f.read()
        last = (out.strip().splitlines() or [""])[-1]
        print(f"  {name}: exit {proc.returncode}, {ends[name] - t0:.3f} s; last line: {last}")
        if proc.returncode != 0:
            with open(os.path.join(cwd, f"{name}.err")) as f:
                err = f.read()
            check(False, f"path 15(d) example {name} exited {proc.returncode}:\n"
                         f"{out[-1500:]}\n{err[-3000:]}")
        check(expect[name] in out, f"path 15(d) example {name} did not print "
                                   f"{expect[name]!r}:\n{out[-2000:]}")


def stop_children(children):
    """Kill the children still running (after a failure)."""
    for _, proc, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--path15"]:
        return path15_main(sys.argv[2], float(sys.argv[3]))
    try:
        card = phase_device()
        phase_build()
        mark("build")
        from petlion_tpu_torch.main_path import newton_matrices
        D, Dp, sizes, groups = newton_matrices()
        k1 = phase_k1(D)
        mark("K1")
        import petlion_tpu_torch as ptt
        D92 = newton_matrices(chemistry=ptt.NMC, aging="SEI")[0]
        D91 = newton_matrices(chemistry=ptt.NMC_LGM50, temperature=False,
                              aging="stress")[0]
        k1_92 = phase_k1_core92([("SEI", D92), ("stress", D91)])
        mark("K1 n=92")
        D121 = newton_matrices(temperature=True, hold_dT=True)[0]
        k1_121 = phase_k1_core121(D121)
        mark("K1 n=121")
        from petlion_tpu_torch.main_path import particle_schur_cores
        k1_101 = phase_k1_core101(particle_schur_cores())
        mark("K1 n=101")
        k2 = phase_k2(groups)
        mark("K2")
        _, Dp92, sizes92, _ = newton_matrices(chemistry=ptt.NMC, aging="SEI")
        k3 = phase_k3(Dp, sizes, (Dp92, sizes92))
        mark("K3")
        k1t = phase_k1t()
        mark("K1t")
        k3t = phase_k3t(Dp, sizes)
        mark("K3t")
        # paths 1-13 and 15 launch no tangent kernel: every reset checks it
        from petlion_tpu_torch.ops import gj_kernel
        for k in TANGENT_KERNELS:
            gj_kernel.LAUNCHES[k] = 0
        lift_tangent_guard = guard_tangent_launches()
        launches, path1, trip_s = phase_main(card)
        mark("paths 1-2")
        oracle = np.load(ORACLE)
        k1_simulate, fast3 = phase_simulate(card, oracle)
        mark("path 3")
        k1_tstops = phase_tstops(card, oracle, path1)
        mark("path 4")
        k1_gitt = phase_gitt(card)
        mark("path 5")
        k1_cccv = phase_cccv(card)
        mark("path 6")
        sei1, sei1_by_n, sei2 = phase_sei(card)
        mark("path 7")
        k1_cycling = phase_sei_cycling(card)
        mark("sei cycling")
        k1_variants = phase_variants(card)
        mark("variants")
        k1_protocol = phase_protocol(card)
        mark("path 8")
        k1_thermal, lu_thermal = phase_thermal(card)
        mark("path 9")
        lu_batched = phase_thermal_batched(card)
        mark("path 10")
        k1_options = phase_solver_options(card, oracle, path1,
                                          launches["path 1"]["gj_inverse"])
        mark("paths 11-12")
        k1_dense, k1_n101 = phase_dense(card, oracle, fast3)
        mark("path 13")
        gj_kernel.reset_launch_counts()     # the last check of paths 1-13
        lift_tangent_guard()
        # path 15 runs in processes of its own beside path 14, on other host
        # cores: the script's time limit
        children = [start_path15_child(card, trip_s)] + start_examples()
        try:
            tangent_launches = phase_estimation(card)
            mark("path 14")
            k1_15 = finish_path15_child(children[0])
            mark("path 15(a-c)")
            finish_examples(card, children[1:])
            mark("path 15(d)")
        finally:
            stop_children(children)
    except Exception:   # report any phase failure and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    k1_path15 = sum(k1_15.values())
    k1_launches = (launches["path 1"]["gj_inverse"] + k1_simulate + k1_tstops + k1_gitt
                   + k1_cccv + k1_protocol + k1_options + k1_dense + k1_path15)
    print(f"K1 launches: path 1 {launches['path 1']['gj_inverse']}, simulate "
          f"{k1_simulate}, tstops {k1_tstops}, gitt {k1_gitt}, cccv {k1_cccv}, protocol "
          f"(path 8) {k1_protocol}, in all {k1_launches}; path 7 {sei1['gj_inverse']} "
          f"({sei1_by_n['gj_inverse'].get(92, 0)} at n = 92), sei cycling {k1_cycling}, "
          f"variants {k1_variants}; path 7's full-kernel route: K2 {sei2['gj_blocks']}, "
          f"K3 {sei2['dchain']}; path 9 float64 {k1_thermal} at n = 121; pivoted LU "
          f"factorizations: path 9 float32 {lu_thermal}, path 10's first chunk {lu_batched}; "
          f"paths 11-12 {k1_options}, path 13 {k1_dense} at n = 71 and {k1_n101} at n = 101; "
          f"path 15 {k1_path15} ((a) {k1_15['a']}, (b) {k1_15['b']}, (c) {k1_15['c']})")
    print("phase walls: " + ", ".join(f"{name} {wall:.1f} s" for name, wall in phase_walls()))
    print(f"chip_smoke wall: {time.time() - T_START:.1f} s")
    records = [
        {"name": "gj_inverse", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": k1_launches, **k1},
        {"name": "gj_inverse_n92", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": sei1_by_n["gj_inverse"].get(92, 0), **k1_92},
        {"name": "gj_inverse_n121_f64", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": k1_thermal, **k1_121},
        {"name": "gj_inverse_n101", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": k1_n101, **k1_101},
        {"name": "gj_blocks", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_blocks.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": launches["path 2"]["gj_blocks"], **k2},
        {"name": "dchain", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/dchain.cu",
         "replaces": "petlion_tpu/ops/pallas_schur.py:82",
         "launches": launches["path 2"]["dchain"], **k3},
        # the tangents: the port's counterparts of Pallas's JVP of the same
        # TPU kernels, which the JAX package's jax.jacfwd runs on a TPU
        {"name": "gj_tangent", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_tangent.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": tangent_launches["gj_tangent"], **k1t},
        {"name": "dchain_tangent", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/dchain_tangent.cu",
         "replaces": "petlion_tpu/ops/pallas_schur.py:82",
         "launches": tangent_launches["dchain_tangent"], **k3t},
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
