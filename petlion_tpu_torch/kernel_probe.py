"""Where K1 and K3 spend their time on the card, and what their launch
choices are worth. Run on a machine with an NVIDIA GPU and nvcc:

    python -m petlion_tpu_torch.kernel_probe

1. variants: copies of ``csrc/gj_inverse.cu`` and ``csrc/dchain.cu`` with one
   launch choice changed (registers a thread through the blocks an SM asked
   for; tile rows a group in the elimination's update), each built with
   nvcc into ``build/probe/`` (ptxas registers and spills printed) and timed
   at the main path's shapes — K1 at (1024, 71, 71), K3 on the permuted
   Newton cores tiled to 1024 cells, sizes (20, 20), float32 — over four
   rotating inputs behind a spin kernel, as ``chip_smoke.py`` times them;
2. phases: copies of the shipped sources with clock64 stamps on thread 0
   of every block, printing the mean cycles per block in each phase.

The shipped sources are not changed; the copies live under ``build/probe``.
"""

from __future__ import annotations

import ctypes
import subprocess
import time

import numpy as np
import torch

from .main_path import newton_matrices
from .ops import dchain as kd
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
    """Build {key: (source name, source text, header text)} in parallel:
    {key: (library path or None, ptxas lines of the main-path kernel)}."""
    procs = {}
    for i, (key, (name, src, header)) in enumerate(jobs.items()):
        d = OUT / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "gj_common.cuh").write_text(header)
        (d / f"{name}.cu").write_text(src)
        procs[key] = (d / "lib.so", subprocess.Popen(
            [gk._nvcc(), *gk.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, p) in procs.items():
        log = p.communicate()[0].splitlines()
        # the float kernels that the main path launches: K1 at T = 8, P = 9,
        # K3 at T = 8, P = 4
        mark = ("kernelIfLi8ELi9E", "kernelIfLi8ELi4E")
        info = [" | ".join(y.split(":", 1)[-1].strip() for y in log[i + 1:i + 4]
                           if "registers" in y or "spill" in y)
                for i, x in enumerate(log) if "Compiling entry" in x and any(m in x for m in mark)]
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
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


if __name__ == "__main__":
    main()
