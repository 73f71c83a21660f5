#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
`ok` line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 set off and asserted off, and the port must refuse a
   float32 CUDA run while matmul TF32 is on;
2. build: compile the Gauss-Jordan kernel (petlion_tpu_torch/csrc/
   gj_inverse.cu) from the checkout with nvcc;
3. kernel: hold the kernel against its plain PyTorch version on the card at
   (B, n) = (1024, 71), (5, 71), (8, 37), (3, 17) in float32 (max |Δ| ≤ 2e-4,
   ‖AX − I‖∞ < 1e-3) and at (64, 71) in float64 (max |Δ| ≤ 1e-10), and time
   it with CUDA events beside its bound, the plain version and
   torch.linalg.inv (a yardstick the port never calls);
4. main path (petlion_tpu_torch/main_path.py): `batch_simulate` of 1024 LCO
   cells, a 1C discharge from SOC 1 in float32 with the benchmark options,
   D_sp/D_sn/k_p/k_n perturbed ±5% per cell from a numpy seed (cell 0
   unperturbed). Every cell must exit with flag 0, 1 or 3, the kernel must
   have been launched during the run, and cell 0 must land within 5 s and
   8e-3 V of the float64 oracle (tests/data/oracle_lco_1c.npz). Then three
   warm runs of one batch: their median wall gives discharges/s, their
   spread the timing noise within one process.

The line before the last is the kernels' JSON record; the last line is
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
    gj_kernel.build()
    print(f"build: {time.time() - t0:.2f} s ({gj_kernel.SOURCE.name})")
    for line in gj_kernel.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _equilibrated_inputs(B, n, dtype, seed):
    import numpy as np
    import torch
    from petlion_tpu_torch.solver.linsolve import _equilibrate
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + 20.0 * np.eye(n)
    A = torch.as_tensor(A, dtype=dtype, device="cuda")
    return _equilibrate(A)[0].contiguous()


def phase_kernel():
    import torch
    from petlion_tpu_torch.ops import gj_kernel as gk
    rows = {}
    for B, n in ((1024, 71), (5, 71), (8, 37), (3, 17)):
        A = _equilibrated_inputs(B, n, torch.float32, seed=B * 1000 + n)
        X = gk.gj_inverse_cuda(A)
        P = gk.gj_inverse_blocked(A, bs=gk._best_bs(n))
        torch.cuda.synchronize()
        err = float((X - P).abs().max())
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        resid = float((A.double() @ X.double() - eye).abs().amax(dim=(-2, -1)).max())
        print(f"kernel f32 ({B}, {n}): max|kernel - plain| = {err:.3e}, "
              f"max ||AX - I||inf = {resid:.3e}")
        check(err <= 2e-4, f"kernel disagrees with plain at ({B}, {n}): {err}")
        check(resid < 1e-3, f"kernel inverse residual at ({B}, {n}): {resid}")
        rows[(B, n)] = err
    A64 = _equilibrated_inputs(64, 71, torch.float64, seed=64071)
    err64 = float((gk.gj_inverse_cuda(A64)
                   - gk.gj_inverse_blocked(A64, bs=gk._best_bs(71))).abs().max())
    print(f"kernel f64 (64, 71): max|kernel - plain| = {err64:.3e}")
    check(err64 <= 1e-10, f"float64 kernel disagrees with plain: {err64}")

    B, n = 1024, 71
    A = _equilibrated_inputs(B, n, torch.float32, seed=7)
    ms = cuda_time_ms(lambda: gk.gj_inverse_cuda(A), reps=50)
    plain_ms = cuda_time_ms(lambda: gk.gj_inverse_blocked(A, bs=gk._best_bs(n)),
                            reps=10)
    library_ms = cuda_time_ms(lambda: torch.linalg.inv(A), reps=20)
    bytes_ms = 2 * B * n * n * 4 / PEAK_BYTES_PER_S * 1e3
    flops_ms = 2 * n ** 3 * B / PEAK_FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    print(f"kernel timing ({B}, {n}) f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.linalg.inv {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f}, fp32 ops {flops_ms:.4f})")
    return dict(max_abs_err=rows[(1024, 71)], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= flops_ms else "operations")


def phase_main(card):
    import numpy as np
    from petlion_tpu_torch import main_path as mp
    from petlion_tpu_torch.ops import gj_kernel as gk

    p = mp.model(device="cuda")
    oracle = np.load(ORACLE)
    gk.reset_launch_counts()
    res, wall = mp.run(p, seed=0)
    launches = gk.LAUNCHES["gj_inverse"]
    flags = res.flag.cpu().numpy()
    steps = res.n_steps.cpu().numpy().astype(float)
    att = steps + res.n_rejected.cpu().numpy()
    t_end = float(res.t_final[0])
    V_end = float(p.layout.V(res.y_final[0]))
    print(f"main path (first run, includes plan build): {wall:.3f} s for "
          f"{mp.B_MAIN} cells, gj_inverse launches {launches}")
    print(f"  flags {dict(zip(*np.unique(flags, return_counts=True)))}; "
          f"steps/cell mean {steps.mean():.2f}, attempts/cell mean "
          f"{att.mean():.2f} max {att.max():.0f}")
    print(f"  cell 0: t_end {t_end:.4f} s (oracle {float(oracle['t_end']):.4f}), "
          f"V_end {V_end:.5f} V (oracle {float(oracle['V_end']):.5f})")
    check(launches > 0, "the main path never launched the gj_inverse kernel")
    check(bool(np.isin(flags, (0, 1, 3)).all()),
          f"cells exited with flags {sorted(set(flags.tolist()))}")
    check(bool(np.isfinite(res.y_final.cpu().numpy()).all()), "non-finite final states")
    check(abs(t_end - float(oracle["t_end"])) <= 5.0, "cell 0 exit time off the oracle")
    check(abs(V_end - float(oracle["V_end"])) <= 8e-3, "cell 0 V_end off the oracle")

    # warm runs of one batch in this process: the end-to-end metric is their
    # median, and their spread is the noise within one process
    res2, walls, med, spread = mp.warm_walls(p, seed=1)
    check(bool(np.isin(res2.flag.cpu().numpy(), (0, 1, 3)).all()), "warm run: bad flags")
    att2 = (res2.n_steps + res2.n_rejected).cpu().numpy()
    print(f"main path (warm, {len(walls)} runs of one batch): walls "
          f"{', '.join(f'{w:.3f}' for w in walls)} s, median {med:.3f} s = "
          f"{mp.B_MAIN / med:.1f} discharges/s, spread {spread:.1%}; "
          f"attempts/cell mean {att2.mean():.2f} max {att2.max()} [{card}]")
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
        k = phase_kernel()
        launches = phase_main(card)
    except Exception:   # report any phase failure and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    record = {"name": "gj_inverse", "route": "cuda",
              "source": "petlion_tpu_torch/csrc/gj_inverse.cu",
              "replaces": "petlion_tpu/ops/pallas_gj.py:57",
              "launches": launches, **k}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
