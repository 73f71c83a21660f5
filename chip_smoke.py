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
   (7, 10), (7, 17), (7, 30) in float32 (max |Δ| ≤ 2e-4, ‖AX − I‖∞ < 1e-3)
   and (10240, 10), (1024, 30) in float64 (≤ 1e-10), random diagonally
   dominant matrices, equilibrated; then the particle and c_e blocks of
   real Newton matrices;
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
   than the 50 MB L2) behind a spin kernel that holds the stream while the
   host queues the launches, so the time is the device's; K2 is timed as
   before (one input, CUDA events around back-to-back launches);
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

The line before the last is the kernels' JSON record (one entry per kernel;
`launches` is the count of the path that runs it: path 1 for K1, path 2 for
K2 and K3); the last line is {"ok": true, "device": {...}}.
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
ROTATING = 4        # input buffers rotated in the K1 and K3 timings


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
    """Device ms per call of fn, rotating over `inputs` (so that the reads
    come from device memory when the inputs exceed the L2). With `spin`, a
    spin kernel holds the stream while the host queues the calls, so CUDA
    events time the queued calls alone (checked: the host must queue them
    faster than the spin lasts); without, as cuda_time_ms (for the plain
    versions, whose host work is part of what they cost)."""
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
    return start.elapsed_time(stop) / reps


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
    ms = device_ms(gk.gj_inverse_cuda, bufs, reps=200)
    plain_ms = device_ms(lambda A: gk.gj_inverse_blocked(A, bs=gk._best_bs(n)), bufs,
                         reps=8, spin=False)
    library_ms = device_ms(lambda A: torch.linalg.inv_ex(A)[0], bufs, reps=8, spin=False)
    bound_ms, by = _bound(2 * B * n * n * 4, 2 * n ** 3 * B)
    print(f"kernel timing ({B}, {n}) f32, {ROTATING} rotating inputs: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.linalg.inv_ex {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of it reached)")
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
        torch.cuda.synchronize()
        err = float((X - P).abs().max())
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        resid = float((A.double() @ X.double() - eye).abs().amax(dim=(-2, -1)).max())
        print(f"K2 {str(dtype)[6:]} ({M}, {n}, {n}): max|kernel - plain| = {err:.3e}, "
              f"max ||AX - I||inf = {resid:.3e} (tol {tol:g})")
        check(err <= tol, f"K2 disagrees with plain at ({M}, {n}) {dtype}: {err}")
        check(resid < 1e-3, f"K2 inverse residual at ({M}, {n}) {dtype}: {resid}")
        errs[(M, n, dtype)] = err
    # blocks of real Newton matrices: as close to the float64 inverse as the
    # plain float32 version is
    for G in groups:
        n = G.shape[-1]
        A64 = G.reshape(-1, n, n).to("cuda").repeat(128, 1, 1).contiguous()
        ref = kb.gj_blocks_plain(A64)
        scale = float(ref.abs().max())
        e_k = float((kb.gj_blocks_cuda(A64.float()).double() - ref).abs().max()) / scale
        e_p = float((kb.gj_blocks_plain(A64.float()).double() - ref).abs().max()) / scale
        e_64 = float((kb.gj_blocks_cuda(A64) - ref).abs().max()) / scale
        print(f"K2 real blocks {tuple(A64.shape)}: f32 error vs f64 / scale: kernel "
              f"{e_k:.3e}, plain {e_p:.3e}; f64 kernel vs plain {e_64:.3e}")
        check(e_k <= 4 * e_p + 1e-5, f"K2 less accurate than plain on real blocks: {e_k}")
        check(e_64 <= 1e-10, f"K2 float64 disagrees on real blocks: {e_64}")

    timings = {}
    for M, n in ((10240, 10), (1024, 30)):
        A = _equilibrated_inputs(M, n, torch.float32, seed=3)
        ms = cuda_time_ms(lambda: kb.gj_blocks_cuda(A), reps=100)
        plain_ms = cuda_time_ms(lambda: kb.gj_blocks_plain(A), reps=10)
        library_ms = cuda_time_ms(lambda: torch.linalg.inv(A), reps=20)
        bound_ms, by = _bound(2 * M * n * n * 4, 2 * n ** 3 * M)
        print(f"K2 timing ({M}, {n}, {n}) f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.linalg.inv {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        timings[(M, n)] = (ms, plain_ms, library_ms, bound_ms, by)
    ms, plain_ms, library_ms, bound_ms, by = timings[(10240, 10)]
    return dict(max_abs_err=errs[(10240, 10, torch.float32)], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=by)


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
    ms = device_ms(lambda D: kd.dchain_cuda(D, sizes), bufs, reps=200)
    plain_ms = device_ms(lambda D: kd.dchain_plain(D, sizes), bufs, reps=8, spin=False)
    B = bufs[0].shape[0]
    bound_ms, by = _bound((n * n + out_elems) * 4 * B, _dchain_flops(n, sizes) * B)
    print(f"K3 timing ({B}, {n}, {n}) sizes {sizes} f32, {ROTATING} rotating inputs: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no single PyTorch call computes "
          f"the chain, bound {bound_ms:.4f} ms ({by}: "
          f"{(n * n + out_elems) * 4 * B / 1e6:.1f} MB, "
          f"{_dchain_flops(n, sizes) * B / 1e9:.3f} GFLOP; {bound_ms / ms:.1%} of it reached)")
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
    return launches


def phase_main(card):
    import numpy as np
    from petlion_tpu_torch import main_path as mp

    p = mp.model(device="cuda")
    oracle = np.load(ORACLE)
    launches = {}
    for name, route, needs in (("path 1", mp.PATH1, ("gj_inverse",)),
                               ("path 2", mp.PATH2, ("gj_inverse", "gj_blocks", "dchain"))):
        launches[name] = drive_path(mp, p, name, route, oracle, mp.B_MAIN, needs)
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
    return launches


def main():
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
        launches = phase_main(card)
    except Exception:   # report any phase failure and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    records = [
        {"name": "gj_inverse", "route": "cuda",
         "source": "petlion_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "petlion_tpu/ops/pallas_gj.py:57",
         "launches": launches["path 1"]["gj_inverse"], **k1},
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
