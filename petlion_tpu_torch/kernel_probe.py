"""Where the kernels spend their time on the card, and what their launch
choices are worth. Run on a machine with an NVIDIA GPU and nvcc:

    python -m petlion_tpu_torch.kernel_probe [k1k3] [k2] [--k2-baseline FILE]

(both parts by default).

k1k3. 1. variants: copies of ``csrc/gj_inverse.cu`` and ``csrc/dchain.cu``
   with one launch choice changed (registers a thread through the blocks an
   SM asked for; tile rows a group in the elimination's update), each built
   with nvcc into ``build/probe/`` (ptxas registers and spills printed) and
   timed at the main path's shapes — K1 at (1024, 71, 71), K3 on the
   permuted Newton cores tiled to 1024 cells, sizes (20, 20), float32 — over
   four rotating inputs behind a spin kernel, as ``chip_smoke.py`` times
   them; 2. phases: copies of the shipped sources with clock64 stamps on
   thread 0 of every block, printing the mean cycles per block in each phase.
k2. 1. variants: copies of ``csrc/gj_blocks.cu`` with one design choice
   changed (16 or 32 lanes a matrix at n = 10 instead of 10; the pivot row
   through shared memory instead of shuffles; the pivot loop rolled; rows
   read straight from device memory instead of staged through shared
   memory; four or eight warps a block instead of two),
   and with ``--k2-baseline`` another K2 source of the same C interface
   (an earlier version, say, unpacked from git), timed at the main path's
   two shapes, (10240, 10, 10) and (1024, 30, 30) in float32, over sixteen
   rotating inputs (60-66 MB) behind a spin kernel, as ``chip_smoke.py``
   times K2, in the order baseline, shipped, variants, shipped, baseline;
   2. phases: the shipped source built with ``-DGJ_BLOCKS_PROBE`` (clock64
   stamps on lane 0 of every warp), printing the mean cycles per warp in
   the load, the elimination and the store.

The shipped sources are not changed; the copies live under ``build/probe``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .main_path import newton_matrices
from .ops import dchain as kd
from .ops import gj_blocks as kb
from .ops import gj_kernel as gk
from .solver.linsolve import _equilibrate

OUT = gk.BUILD_DIR.parent / "probe"
SPIN_CYCLES = 120_000_000
B, N = 1024, 71

K1_MIN_BLOCKS = "return (sizeof(S) == 4 && T == 8) ? 4 : 1;"
K3_MIN_BLOCKS = "return T > 8 ? 1 : (sizeof(S) == 4 ? 8 : 4);"
GROUP = "constexpr int G = (sizeof(S) == 8 || P <= 4) ? 1 : T == 8 ? 3 : 2;"
# name: (kernel source, {text: replacement})
VARIANTS = {
    "K1 shipped (4 blocks an SM, 3 rows a group)": ("gj_inverse", {}),
    "K1 8 blocks an SM (128 registers)": (
        "gj_inverse", {K1_MIN_BLOCKS: K1_MIN_BLOCKS.replace("? 4", "? 8")}),
    "K1 2 rows a group": ("gj_inverse", {GROUP: GROUP.replace("? 3", "? 2")}),
    "K3 shipped (8 blocks an SM)": ("dchain", {}),
    "K3 4 blocks an SM": ("dchain", {K3_MIN_BLOCKS: K3_MIN_BLOCKS.replace("? 8", "? 4")}),
}

STAMP = "{ long long n_ = clock64(); acc_[%d] += n_ - t_; t_ = n_; }"
PROF_DECL = "__device__ long long g_prof[2048 * 8];\n"
K1_PHASES = ["load", "store", "(i) publish + barrier", "(ii) 8x8 inverse",
             "(iii) R + barrier", "(iv) update"]
K3_PHASES = ["load", "inverses", "AinvB", "Schur", "last copy"]

K2_SHAPES = ((10240, 10), (1024, 30))
K2_ROTATING = 16
# name: {text: replacement} in csrc/gj_blocks.cu
K2_VARIANTS = {
    "K2 16 lanes a matrix at n = 10 (2 a warp)": {"kLanesAt10 = 10;": "kLanesAt10 = 16;"},
    "K2 32 lanes a matrix at n = 10 (1 a warp)": {"kLanesAt10 = 10;": "kLanesAt10 = 32;"},
    "K2 pivot rows through shared memory": {"kShuffleRows = true;": "kShuffleRows = false;"},
    "K2 pivot loop rolled": {"kUnrollPivots = true;": "kUnrollPivots = false;"},
    "K2 rows straight from device memory": {"kStageInShared = true;": "kStageInShared = false;"},
    "K2 four warps a block": {"kWarps = 2;": "kWarps = 4;"},
    "K2 eight warps a block": {"kWarps = 2;": "kWarps = 8;"},
}
K2_PHASES = ["load", "elimination", "store"]


def _replace(text, old, new):
    if old not in text:
        raise RuntimeError(f"probe anchor not found in the source: {old[:60]!r}")
    return text.replace(old, new, 1)


def _instrumented(name):
    """(source, header) of `name` with clock64 stamps per phase."""
    csrc = gk.CSRC
    header = (csrc / "gj_common.cuh").read_text()
    src = (csrc / f"{name}.cu").read_text()
    save = ("    if (threadIdx.x == 0 && blockIdx.x < 2048)\n"
            "        for (int i = 0; i < 8; ++i) {prof}[blockIdx.x * 8 + {off} + i] = acc_[i];\n")
    if name == "gj_inverse":
        header = _replace(header, "namespace gjc {\n", "namespace gjc {\n" + PROF_DECL)
        header = _replace(header, "    for (int kb = 0; kb * BS < m; ++kb) {",
                          "    long long t_ = clock64(), acc_[8] = {};\n"
                          "    for (int kb = 0; kb * BS < m; ++kb) {")
        parts = header.split("        __syncthreads();\n")
        if len(parts) != 3:
            raise RuntimeError("probe: expected two barriers in tile_gj")
        header = (parts[0] + "        __syncthreads();\n        " + STAMP % 0 + "\n" + parts[1]
                  + "        __syncthreads();\n        " + STAMP % 2 + "\n" + parts[2])
        header = _replace(header, "            __syncwarp();\n        }\n",
                          "            __syncwarp();\n        }\n        " + STAMP % 1 + "\n")
        header = _replace(header,
                          "                    v[a][b] = (prow && a == pp) ? (colk ? pv : rb) : upd;\n"
                          "                }\n            }\n        }\n",
                          "                    v[a][b] = (prow && a == pp) ? (colk ? pv : rb) : upd;\n"
                          "                }\n            }\n        }\n        " + STAMP % 3 + "\n")
        header = _replace(header, "        }\n        " + STAMP % 3 + "\n    }\n}\n",
                          "        }\n        " + STAMP % 3 + "\n    }\n"
                          + save.replace("8; ++i", "4; ++i").format(prof="g_prof", off=2) + "}\n")
        src = _replace(src, "    S v[P][P];\n",
                       "    long long t_ = clock64(), acc_[8] = {};\n    S v[P][P];\n")
        src = _replace(src, "    gjc::tile_gj<S, T, P>(v, n, sm, ty, tx);\n",
                       "    { S x = S(0); for (int a = 0; a < P; ++a) for (int b = 0; b < P; ++b)"
                       " x += v[a][b]; if (x == S(-12345)) acc_[7] = 1; }\n    " + STAMP % 0
                       + "\n    gjc::tile_gj<S, T, P>(v, n, sm, ty, tx);\n    t_ = clock64();\n")
        src = _replace(src, "    gjc::tile_store<S, T, P>(v, out + off, n, n, ty, tx);\n",
                       "    gjc::tile_store<S, T, P>(v, out + off, n, n, ty, tx);\n    " + STAMP % 1
                       + "\n    if (threadIdx.x == 0 && blockIdx.x < 2048)\n"
                       "        for (int i = 0; i < 2; ++i) gjc::g_prof[blockIdx.x * 8 + i] = acc_[i];\n")
        src += ('\nextern "C" int probe_copy(long long* h) {\n'
                "    return (int)cudaMemcpyFromSymbol(h, gjc::g_prof, sizeof(gjc::g_prof));\n}\n")
    else:
        src = _replace(src, "namespace {\n", "namespace {\n" + PROF_DECL)
        src = _replace(src, "    const long long b = blockIdx.x;\n",
                       "    const long long b = blockIdx.x;\n"
                       "    long long t_ = clock64(), acc_[8] = {};\n")
        src = _replace(src, "    int o = 0, m = n;\n", "    " + STAMP % 0 + "\n    int o = 0, m = n;\n")
        src = _replace(src, "        equil_inverse<S, T, P>(Sc, n, nk, rc, rr, buf);\n",
                       "        equil_inverse<S, T, P>(Sc, n, nk, rc, rr, buf);\n        "
                       + STAMP % 1 + "\n")
        src = _replace(src, "        copy_out<NW>(Sc, n, nk, nk, invA_out, lane, warp);\n"
                            "        __syncthreads();\n",
                       "        copy_out<NW>(Sc, n, nk, nk, invA_out, lane, warp);\n"
                       "        __syncthreads();\n        " + STAMP % 2 + "\n")
        src = _replace(src, "                             nullptr);\n        __syncthreads();\n",
                       "                             nullptr);\n        __syncthreads();\n        "
                       + STAMP % 3 + "\n")
        src = _replace(src, "    equil_inverse<S, T, P>(Sc, n, m, rc, rr, buf);\n",
                       "    equil_inverse<S, T, P>(Sc, n, m, rc, rr, buf);\n    " + STAMP % 1 + "\n")
        src = _replace(src, "b * m * m, lane, warp);\n}\n",
                       "b * m * m, lane, warp);\n    " + STAMP % 4 + "\n"
                       + save.format(prof="g_prof", off=0) + "}\n")
        src += ('\nextern "C" int probe_copy(long long* h) {\n'
                "    return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n")
    return src, header


def _build_all(jobs):
    """Build {key: (source name, source text, header text[, nvcc flags])} in
    parallel: {key: (library path or None, ptxas lines of the main-path
    kernels)}."""
    procs = {}
    for key, (name, src, header, *flags) in jobs.items():
        d = OUT / re.sub(r"[^A-Za-z0-9]+", "_", key)
        d.mkdir(parents=True, exist_ok=True)
        (d / "gj_common.cuh").write_text(header)
        (d / f"{name}.cu").write_text(src)
        procs[key] = (d / "lib.so", subprocess.Popen(
            [gk._nvcc(), *gk.NVCC_FLAGS, *(flags[0] if flags else ()), "-o", str(d / "lib.so"),
             str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, p) in procs.items():
        log = p.communicate()[0].splitlines()
        # the float kernels that the main path launches: K1 at T = 8, P = 9,
        # K3 at T = 8, P = 4, K2 at n = 10 and 30
        mark = ("kernelIfLi8ELi9E", "kernelIfLi8ELi4E", "Li10EEEv", "Li30EEEv")
        info = [re.search(r"kernelI(\w+?)EvP", x).group(1) + ": " + " | ".join(
                    y.split(":", 1)[-1].strip() for y in log[i + 1:i + 4]
                    if "registers" in y or "spill" in y)
                for i, x in enumerate(log) if "Compiling entry" in x and "kernelIf" in x
                and any(m in x for m in mark)]
        built[key] = (so if p.returncode == 0 else None, info or [l for l in log if "error" in l][:3])
    return built


def _spin_ms(call, n_inputs, reps=300):
    for i in range(n_inputs):
        call(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for i in range(reps):
        call(i % n_inputs)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _inputs():
    rng = np.random.default_rng(0)
    k1 = []
    for _ in range(4):
        A = rng.standard_normal((B, N, N)) + 20.0 * np.eye(N)
        k1.append(_equilibrate(torch.as_tensor(A, dtype=torch.float32, device="cuda"))[0]
                  .contiguous())
    _, Dp, sizes, _ = newton_matrices()
    k3 = [Dp.to("cuda").float().repeat(B // Dp.shape[0], 1, 1).contiguous() for _ in range(4)]
    return k1, k3, tuple(sizes)


def _caller(lib, name, k1, k3, sizes):
    """call(i) launching the library's float kernel on input i."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if name == "gj_inverse":
        outs = [torch.empty_like(x) for x in k1]
        fn = lib.gj_inverse_f32
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        return lambda i: fn(k1[i].data_ptr(), outs[i].data_ptr(), B, N, stream), outs
    outs = [[torch.empty((B,) + s, device="cuda") for s in kd.out_shapes(N, sizes)] for _ in k3]
    ptrs = [(ctypes.c_void_p * len(o))(*(t.data_ptr() for t in o)) for o in outs]
    csz = (ctypes.c_int * len(sizes))(*sizes)
    fn = lib.dchain_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lambda i: fn(k3[i].data_ptr(), ptrs[i], csz, len(sizes), B, N, stream), outs


def probe_k1_k3():
    header = (gk.CSRC / "gj_common.cuh").read_text()
    jobs = {}
    for key, (name, subs) in VARIANTS.items():
        src = (gk.CSRC / f"{name}.cu").read_text()
        hdr = header
        for old, new in subs.items():
            if old in src:
                src = _replace(src, old, new)
            else:
                hdr = _replace(hdr, old, new)
        jobs[key] = (name, src, hdr)
    for name in ("gj_inverse", "dchain"):
        jobs[f"phases {name}"] = (name, *_instrumented(name))
    t0 = time.time()
    built = _build_all(jobs)
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s")
    k1, k3, sizes = _inputs()
    ref1 = gk.gj_inverse_inplace(k1[0])
    ref3 = kd.dchain_mirror(k3[0], sizes)
    for key, (so, info) in built.items():
        name = jobs[key][0]
        if so is None:
            print(f"{key}: build failed: {info}")
            continue
        call, outs = _caller(ctypes.CDLL(str(so)), name, k1, k3, sizes)
        if call(0) != 0:
            print(f"{key}: launch failed")
            continue
        torch.cuda.synchronize()
        if name == "gj_inverse":
            err = float((outs[0] - ref1).abs().max())
        else:
            err = max(float((a - r).abs().max() / r.abs().max()) for a, r in zip(outs[0], ref3))
        if key.startswith("phases"):
            lib = ctypes.CDLL(str(so))
            h = (ctypes.c_longlong * (2048 * 8))()
            call(1)
            torch.cuda.synchronize()
            if lib.probe_copy(h) != 0:
                raise RuntimeError(f"{key}: copying the phase stamps failed")
            a = np.frombuffer(h, dtype=np.int64).reshape(2048, 8)[:B]
            names = K1_PHASES if name == "gj_inverse" else K3_PHASES
            print(f"{key}, mean cycles a block (thread 0): " + ", ".join(
                f"{nm} {a[:, i].mean():.0f}" for i, nm in enumerate(names))
                + f"; sum {a[:, :len(names)].sum(1).mean():.0f}")
            continue
        ms = _spin_ms(call, len(outs))
        print(f"{key}: {ms:.4f} ms, max |kernel - mirror| {err:.2e}; ptxas: {'; '.join(info)}")


def _k2_inputs():
    """{(M, n): K2_ROTATING equilibrated diagonally dominant float32 stacks}."""
    rng = np.random.default_rng(1)
    out = {}
    for M, n in K2_SHAPES:
        out[(M, n)] = [
            _equilibrate(torch.as_tensor(rng.standard_normal((M, n, n)) + 20.0 * np.eye(n),
                                         dtype=torch.float32, device="cuda"))[0].contiguous()
            for _ in range(K2_ROTATING)]
    return out


def _k2_caller(lib, inputs):
    """call(i) launching the library's float kernel on input i, and the outputs."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn = lib.gj_blocks_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    outs = [torch.empty_like(x) for x in inputs]
    M, n = inputs[0].shape[0], inputs[0].shape[1]
    return lambda i: fn(inputs[i].data_ptr(), outs[i].data_ptr(), M, n, stream), outs


def probe_k2(baseline=None):
    shipped = (gk.CSRC / "gj_blocks.cu").read_text()
    header = (gk.CSRC / "gj_common.cuh").read_text()
    jobs = {"K2 shipped": ("gj_blocks", shipped, header)}
    if baseline:
        jobs[f"K2 baseline {baseline}"] = ("gj_blocks", Path(baseline).read_text(), header)
    for key, subs in K2_VARIANTS.items():
        src = shipped
        for old, new in subs.items():
            src = _replace(src, old, new)
        jobs[key] = ("gj_blocks", src, header)
    jobs["K2 phases"] = ("gj_blocks", shipped, header, ("-DGJ_BLOCKS_PROBE",))
    t0 = time.time()
    built = _build_all(jobs)
    print(f"built {len(built)} K2 libraries in {time.time() - t0:.1f} s")
    for key, (so, info) in built.items():
        print(f"{key}: ptxas (float, n = 10 and 30): {'; '.join(info)}"
              + ("" if so else " BUILD FAILED"))
    inputs = _k2_inputs()
    refs = {s: kb.gj_blocks_mirror(x[0]) for s, x in inputs.items()}
    callers = {}
    for key, (so, _) in built.items():
        if so is None or key == "K2 phases":
            continue
        lib = ctypes.CDLL(str(so))
        callers[key] = {s: _k2_caller(lib, x) for s, x in inputs.items()}
    # the floor of this timing: one launch of a one-element PyTorch kernel
    one = torch.zeros(1, device="cuda")
    print(f"floor, a one-element x.add_(1): {_spin_ms(lambda i: one.add_(1), 1):.4f} ms")
    keys = list(callers)
    base = [k for k in keys if k.startswith("K2 baseline")]
    order = base + ["K2 shipped"] + [k for k in keys if k not in base + ["K2 shipped"]] \
        + ["K2 shipped"] + base
    for key in order:
        cells = []
        for shape, (call, outs) in callers[key].items():
            if call(0) != 0:
                cells.append(f"{shape}: launch failed")
                continue
            torch.cuda.synchronize()
            err = float((outs[0] - refs[shape]).abs().max())
            cells.append(f"{shape} {_spin_ms(call, len(outs)):.4f} ms "
                         f"(max |kernel - mirror| {err:.2e})")
        print(f"{key}: " + ", ".join(cells))

    so, _ = built["K2 phases"]
    if so is None:
        raise RuntimeError("the K2 phase build failed")
    lib = ctypes.CDLL(str(so))
    per_warp = {10: 32 // int(re.search(r"kLanesAt10 = (\d+);", shipped).group(1)), 30: 1}
    copy = lib.gj_blocks_probe_copy
    copy.argtypes = [ctypes.c_void_p]
    for shape, x in inputs.items():
        call, _ = _k2_caller(lib, x)
        call(0)
        torch.cuda.synchronize()
        call(1)
        torch.cuda.synchronize()
        h = np.zeros((8192, 3), dtype=np.int64)
        if copy(h.ctypes.data) != 0:
            raise RuntimeError("copying the K2 phase stamps failed")
        M, n = shape
        a = h[:min(-(-M // per_warp[n]), len(h))]
        print(f"K2 phases {shape}, mean cycles a warp (lane 0, {len(a)} warps): " + ", ".join(
            f"{nm} {a[:, i].mean():.0f}" for i, nm in enumerate(K2_PHASES))
            + f"; sum {a.sum(1).mean():.0f}; max sum {a.sum(1).max():.0f}")


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    baseline = None
    if "--k2-baseline" in argv:
        baseline = argv[argv.index("--k2-baseline") + 1]
        argv = [a for a in argv if a not in ("--k2-baseline", baseline)]
    parts = argv or ["k1k3", "k2"]
    if "k1k3" in parts:
        probe_k1_k3()
    if "k2" in parts:
        probe_k2(baseline)


if __name__ == "__main__":
    main(sys.argv[1:])
