#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
`ok` line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 set off and asserted off, and the port must refuse a
   float32 CUDA run while matmul TF32 is on;
2. build: compile the three kernels (petlion_tpu_torch/csrc/gj_inverse.cu,
   gj_blocks.cu, dchain.cu) from the checkout, one nvcc per source, all
   started together;
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
4. main paths (petlion_tpu_torch/main_path.py): `batch_simulate` of 1024 LCO
   cells, a 1C discharge from SOC 1 in float32 with the benchmark options,
   D_sp/D_sn/k_p/k_n perturbed ±5% per cell from a numpy seed (cell 0
   unperturbed), on path 1 (analytic assembly, K1 for the core) and path 2
   (the full-kernel route: nested levels, K2 group inverses, K3 chain).
   Each path is driven with the launch counts set to 0 just before and read
   just after. Every cell must exit with flag 0, 1 or 3, each kernel of the
   path must have been launched, and cell 0 must land within 5 s and 8e-3 V
   of the float64 oracle (tests/data/oracle_lco_1c.npz). Then three warm
   runs of one batch per path: their median wall gives discharges/s, their
   spread the timing noise within one process. The colored-sweep route
   (PETLION_JACA=0) is driven once at 64 cells under the same checks.
5. simulate (path 3, `main_path.run_single`): the golden single-cell flow
   on the card in float64 on the default route (K1 for the 71x71 core):
   `simulate(p, I=-1, SOC=1)` must exit "Below min. SOC" within 5 s of
   3600 s and 8e-3 V of the golden 2.9357 V and of the oracle; then
   `simulate_cont(sol, p, 600.0, I="rest")` must reach tf with two runs;
   `sol(t)` must go through the native C++ spline; the solution is saved,
   loaded and resumed; the float32 discharge (abstol 1e-3) must stay within
   5 mV of the float64 trace, each read through its Solution's
   interpolation. K1 must be launched in the phase; three warm float64
   discharges give the single-cell wall.
6. tstops (path 4, `main_path.run_tstops`): path 1's 1024 cells in float32
   with max_save 128, three stop times per cell from a numpy seed in
   [200, 3400] s and a shared discontinuity at 1800 s: every cell must exit
   with flag 3 and record a time within 1e-2 s of each of its stops and of
   1800 − reltol/2, cell 0 within 5 s and 8e-3 V of the oracle; steps and
   attempts per cell are printed beside path 1's; three warm runs.

7. gitt (path 5, `main_path.run_gitt`): 1024 LCO cells in float32 on the
   default route, each discharged at 1C by a batch-first function input
   until its own pulse end (θ `t_pulse_off`, a numpy seed, 250-650 s) and
   resting to 900 s, with that time as the cell's tdiscon, so that each
   cell re-initializes at its own jump: every cell must exit with flag 0,
   record a time within 1e-2 s of its pulse end, carry |I + 1| < 1e-3
   before it (up to 0.01 s) and |I| < 1e-3 after it (from 0.5 s), and end
   within 1 s of 900 s; K1 must be launched, and the trips that ran a
   re-initialization are printed; three warm runs give discharges/s.
8. cccv (path 6, `main_path.run_cccv`, `run_power`, `run_eta`): one cell
   in float64 through `simulate`, 2C from SOC 0 to V_max 4.1 V ("Above max.
   voltage"), then V = "hold" until I_min 0.05C ("Below min. C-rate" with
   |I - 0.05| < 5e-3, or "Above max. SOC") with the power continuous across
   the boundary (rtol 1e-3); then P = -10 W/m² for 600 s (|P + 10| < 1e-6)
   and eta_p = 0.05 V for 60 s (|eta_p - 0.05| < 1e-6) from SOC 0.5. K1 must
   be launched; the warm wall of the CC→CV pair is printed.

The line before the last is the kernels' JSON record (one entry per kernel;
`launches` is the count of the paths that run it: path 1, simulate, tstops,
gitt and cccv for K1, path 2 for K2 and K3); the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "tests", "data", "oracle_lco_1c.npz")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 outside the tensor
# cores (the kernel does scalar FMAs)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# spin that holds the stream while the host queues timed launches: 1.2e8
# cycles, at least 60 ms at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 120_000_000
ROTATING = 4        # input buffers rotated in the K1 and K3 timings (82 MB)
K2_ROTATING = 16    # and in K2's (60-66 MB at either main-path shape)


class SmokeFailure(Exception):
    pass


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


def _bound(n_bytes, flops):
    """(bound ms, bound_by) of work that moves n_bytes and does flops."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def phase_k1(D):
    import torch
    from petlion_tpu_torch.ops import gj_kernel as gk
    from petlion_tpu_torch.solver.linsolve import _equilibrate
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
    As = _equilibrate(D.to("cuda"))[0].repeat(128, 1, 1).contiguous()
    ref = gk.gj_inverse_inplace(As)
    scale = ref.abs().amax(dim=(-2, -1), keepdim=True)

    def rel(X):
        return float(((X.double() - ref).abs() / scale).max())

    e_k = rel(gk.gj_inverse_cuda(As.float()))
    e_m = rel(gk.gj_inverse_inplace(As.float()))
    e_b8 = rel(gk.gj_inverse_blocked(As.float(), bs=8))
    e_b = rel(gk.gj_inverse_blocked(As.float(), bs=gk._best_bs(71)))
    e_s = rel(gk.gj_inverse_inplace(As.float(), bs=1))
    e_64 = float(((gk.gj_inverse_cuda(As) - ref).abs() / scale).max())
    print(f"K1 real cores {tuple(As.shape)}: f32 error vs f64 / scale: kernel {e_k:.3e}, "
          f"mirror {e_m:.3e}, blocked bs=8 {e_b8:.3e}, blocked bs={gk._best_bs(71)} "
          f"{e_b:.3e}, scalar in-place {e_s:.3e}; f64 kernel vs mirror {e_64:.3e}")
    check(e_k <= 4 * e_m + 1e-5 and e_k <= 4 * e_b8 + 1e-5,
          f"K1 less accurate than plain on real cores: {e_k}")
    check(e_64 <= 1e-8, f"K1 float64 disagrees on real cores: {e_64}")

    B, n = 1024, 71
    bufs = [_equilibrated_inputs(B, n, torch.float32, seed=7 + i) for i in range(ROTATING)]
    ms, host_us = device_ms(gk.gj_inverse_cuda, bufs, reps=200)
    plain_ms, _ = device_ms(lambda A: gk.gj_inverse_blocked(A, bs=gk._best_bs(n)), bufs,
                            reps=8, spin=False)
    library_ms, _ = device_ms(lambda A: torch.linalg.inv_ex(A)[0], bufs, reps=8, spin=False)
    bound_ms, by = _bound(2 * B * n * n * 4, 2 * n ** 3 * B)
    print(f"kernel timing ({B}, {n}) f32, {ROTATING} rotating inputs: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.linalg.inv_ex {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of it reached); host "
          f"{host_us:.1f} us per gj_inverse_cuda call")
    return dict(max_abs_err=rows[(1024, 71)], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=by)


def phase_k2(groups):
    import torch
    from petlion_tpu_torch.ops import gj_blocks as kb
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
    for M, n in ((10240, 10), (1024, 30)):
        bufs = [_equilibrated_inputs(M, n, torch.float32, seed=3 + i)
                for i in range(K2_ROTATING)]
        ms, host_us = device_ms(kb.gj_blocks_cuda, bufs, reps=200)
        b2b_ms = cuda_time_ms(lambda: kb.gj_blocks_cuda(bufs[0]), reps=100)
        plain_ms, _ = device_ms(kb.gj_blocks_plain, bufs, reps=8, spin=False)
        inv_ex = lambda A: torch.linalg.inv_ex(A)[0]  # noqa: E731
        # at n = 30 inv_ex synchronises the device itself: timed without the
        # spin, its host waits are part of what it costs
        lib_spin = not waits_for_device(inv_ex, bufs[0])
        library_ms, lib_host_us = device_ms(inv_ex, bufs, reps=20, spin=lib_spin)
        n_bytes = 2 * M * n * n * 4
        bound_ms, by = _bound(n_bytes, 2 * n ** 3 * M)
        print(f"K2 timing ({M}, {n}, {n}) f32, {K2_ROTATING} rotating inputs "
              f"({K2_ROTATING * n_bytes / 2e6:.1f} MB): kernel {ms:.4f} ms (back to back "
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


def _dchain_flops(n, sizes):
    """Operations of the chain on one core: per level an n_k Gauss-Jordan
    inverse (2 n_k^3), AinvB (2 n_k^2 r) and the Schur update (2 r^2 n_k);
    then the inverse of the rest."""
    f, m = 0, n
    for nk in sizes:
        r = m - nk
        f += 2 * nk ** 3 + 2 * nk * nk * r + 2 * r * r * nk
        m = r
    return f + 2 * m ** 3


def phase_k3(Dp, sizes):
    import numpy as np
    import torch
    from petlion_tpu_torch.ops import dchain as kd
    n = Dp.shape[-1]
    out_elems = sum(a * b for a, b in kd.out_shapes(n, sizes))
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

    bufs = [Dp.to("cuda").float().repeat(128, 1, 1).contiguous() for _ in range(ROTATING)]
    ms, host_us = device_ms(lambda D: kd.dchain_cuda(D, sizes), bufs, reps=200)
    plain_ms, _ = device_ms(lambda D: kd.dchain_plain(D, sizes), bufs, reps=8, spin=False)
    B = bufs[0].shape[0]
    bound_ms, by = _bound((n * n + out_elems) * 4 * B, _dchain_flops(n, sizes) * B)
    print(f"K3 timing ({B}, {n}, {n}) sizes {sizes} f32, {ROTATING} rotating inputs: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no single PyTorch call computes "
          f"the chain, bound {bound_ms:.4f} ms ({by}: "
          f"{(n * n + out_elems) * 4 * B / 1e6:.1f} MB, "
          f"{_dchain_flops(n, sizes) * B / 1e9:.3f} GFLOP; {bound_ms / ms:.1%} of it reached); "
          f"host {host_us:.1f} us per dchain_cuda call")
    return dict(max_abs_err=err_rec, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=by)


def drive_path(mp, p, name, route, oracle, n_cells, needs):
    """Drive one path once with the launch counts set to 0 just before and
    read just after; check it; return (launches, result)."""
    import numpy as np
    from petlion_tpu_torch.ops import gj_kernel as gk
    gk.reset_launch_counts()
    res, wall = mp.run(p, seed=0, route=route, n_cells=n_cells)
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
    launches, results = {}, {}
    for name, route, needs in (("path 1", mp.PATH1, ("gj_inverse",)),
                               ("path 2", mp.PATH2, ("gj_inverse", "gj_blocks", "dchain"))):
        launches[name], results[name] = drive_path(mp, p, name, route, oracle,
                                                   mp.B_MAIN, needs)
        if "dchain" in needs:
            # three group inverses (cathode, anode, c_e) per factorisation
            check(launches[name]["gj_blocks"] == 3 * launches[name]["dchain"],
                  f"{name}: {launches[name]['gj_blocks']} K2 launches for "
                  f"{launches[name]['dchain']} factorisations, not 3 each")
        # warm runs of one batch in this process: the end-to-end metric is
        # their median, and their spread is the noise within one process
        res2, walls, med, spread = mp.warm_walls(p, seed=1, route=route)
        check(bool(np.isin(res2.flag.cpu().numpy(), (0, 1, 3)).all()),
              f"{name} warm run: bad flags")
        att2 = (res2.n_steps + res2.n_rejected).cpu().numpy()
        print(f"{name} (warm, {len(walls)} runs of one batch): walls "
              f"{', '.join(f'{w:.3f}' for w in walls)} s, median {med:.3f} s = "
              f"{mp.B_MAIN / med:.1f} discharges/s, spread {spread:.1%}; steps/cell "
              f"mean {res2.n_steps.float().mean().item():.2f}, attempts/cell mean "
              f"{att2.mean():.2f} max {att2.max()} [{card}]")
    drive_path(mp, p, "colored route", mp.COLORED, oracle, 64, ("gj_inverse",))
    return launches, results["path 1"]


def _walls_line(walls):
    import statistics
    med = statistics.median(walls)
    return med, (max(walls) - min(walls)) / med, ", ".join(f"{w:.3f}" for w in walls)


def phase_simulate(card, oracle):
    """Path 3: the golden single-cell flow through `simulate` on the card
    in float64 (default route, K1 for the 71x71 core): discharge, rest,
    interpolation through the native spline, checkpoint and resume, and the
    float32 discharge. Returns the K1 launches of the phase."""
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

    walls = []
    for _ in range(mp.WARM_RUNS):
        s, w = mp.run_single(p)
        walls.append(w)
    med, spread, ws = _walls_line(walls)
    r = s.results[-1]
    print(f"path 3 (warm, {len(walls)} single-cell float64 discharges): walls {ws} s, "
          f"median {med:.3f} s, spread {spread:.1%}; steps {r.n_steps}, attempts "
          f"{r.n_steps + r.n_rejected} [{card}]")
    return launches


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
    walls = []
    for _ in range(mp.WARM_RUNS):
        res2, w = mp.run_tstops(p, seed=0)
        walls.append(w)
    check(bool((res2.flag.cpu().numpy() == 3).all()), "tstops warm run: bad flags")
    med, spread, ws = _walls_line(walls)
    print(f"path 4 (warm, {len(walls)} runs of one batch): walls {ws} s, median "
          f"{med:.3f} s = {mp.B_MAIN / med:.1f} discharges/s, spread {spread:.1%} [{card}]")
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
    import numpy as np
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
    walls = []
    for _ in range(mp.WARM_RUNS):
        res2, w = mp.run_gitt(p, seed=0)
        walls.append(w)
    check_gitt(res2, t_off, mp.GITT_TF)
    med, spread, ws = _walls_line(walls)
    s2 = res2.n_steps.cpu().numpy().astype(float)
    a2 = s2 + res2.n_rejected.cpu().numpy()
    print(f"path 5 (warm, {len(walls)} runs of one batch): walls {ws} s, median {med:.3f} s "
          f"= {mp.B_MAIN / med:.1f} discharges/s, spread {spread:.1%}; steps/cell mean "
          f"{s2.mean():.2f}, attempts/cell mean {a2.mean():.2f} max {a2.max():.0f} [{card}]")
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
    walls = []
    for _ in range(mp.WARM_RUNS):
        s2, w = mp.run_cccv(p)
        walls.append(w)
    check_cccv(s2)
    med, spread, ws = _walls_line(walls)
    print(f"path 6 (warm, {len(walls)} CC→CV pairs): walls {ws} s, median {med:.3f} s, "
          f"spread {spread:.1%} [{card}]")
    return launches


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        card = phase_device()
        phase_build()
        from petlion_tpu_torch.main_path import newton_matrices
        D, Dp, sizes, groups = newton_matrices()
        k1 = phase_k1(D)
        k2 = phase_k2(groups)
        k3 = phase_k3(Dp, sizes)
        launches, path1 = phase_main(card)
        oracle = np.load(ORACLE)
        k1_simulate = phase_simulate(card, oracle)
        k1_tstops = phase_tstops(card, oracle, path1)
        k1_gitt = phase_gitt(card)
        k1_cccv = phase_cccv(card)
    except Exception:   # report any phase failure and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    k1_launches = (launches["path 1"]["gj_inverse"] + k1_simulate + k1_tstops + k1_gitt
                   + k1_cccv)
    print(f"K1 launches: path 1 {launches['path 1']['gj_inverse']}, simulate "
          f"{k1_simulate}, tstops {k1_tstops}, gitt {k1_gitt}, cccv {k1_cccv}, "
          f"in all {k1_launches}")
    records = [
        {"name": "gj_inverse", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": k1_launches, **k1},
        {"name": "gj_blocks", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_blocks.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": launches["path 2"]["gj_blocks"], **k2},
        {"name": "dchain", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/dchain.cu",
         "replaces": "petlion_tpu/ops/pallas_schur.py:82",
         "launches": launches["path 2"]["dchain"], **k3},
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
