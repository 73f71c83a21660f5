"""Where the kernels spend their time on the card, and what their launch
choices are worth. Run on a machine with an NVIDIA GPU and nvcc:

    python -m petlion_tpu_torch.kernel_probe [k1k3] [k2] [tangent] [host]
        [--k2-baseline FILE] [--tangent-baseline DIR]

(k1k3 and k2 by default).

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

tangent. The tangent kernels K1ᵗ (``csrc/gj_tangent.cu``) and K3ᵗ
   (``csrc/dchain_tangent.cu``) as shipped, built with
   ``-DTANGENT_PROBE_NO_PRODUCTS`` (staging and stores only) and with
   ``-DTANGENT_PROBE_NO_STAGING`` (products and stores on whatever shared
   memory holds), and with ``--tangent-baseline`` the two sources of an
   earlier version (their own C interface: one block a matrix or cell),
   each held against the plain versions where it computes the function and
   timed over rotating inputs behind a spin kernel, as ``chip_smoke.py``
   times them, at the estimation path's shapes and the large ones, in the
   order baseline, shipped, variants, shipped, baseline; two torch.bmm
   beside each K1ᵗ shape; ptxas registers and spills of every instance.

host. The host time of one K3ᵗ launch (``dchain.dchain_tangent_cuda``)
   taken apart: its checks, the allocation of its seven outputs, the host
   array of pointers, the bare ctypes launch, the launch with its library
   lookup and count, and the whole wrapper, each called 200 times in a loop
   behind a spin kernel (so the device never holds the host back), five
   times over: µs a call, median and range, at (1, 71) float64 and
   (1024, 71) float64 and float32, levels (20, 20).

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


TANGENT_K1_SHAPES = (((1, 71), torch.float64), ((2, 71), torch.float64),
                     ((10, 10), torch.float64), ((1, 30), torch.float64),
                     ((20, 10), torch.float64), ((2, 30), torch.float64),
                     ((1024, 71), torch.float32), ((1024, 30), torch.float32),
                     ((1024, 30), torch.float64), ((10240, 10), torch.float32),
                     ((10240, 10), torch.float64))
TANGENT_K3_SHAPES = ((1, torch.float64), (2, torch.float64), (1024, torch.float64),
                     (1024, torch.float32))
TANGENT_VARIANTS = {"no products": ("-DTANGENT_PROBE_NO_PRODUCTS",),
                    "no staging": ("-DTANGENT_PROBE_NO_STAGING",),
                    "phases": ("-DTANGENT_PROBE_CLOCKS",),
                    "phases no staging": ("-DTANGENT_PROBE_CLOCKS", "-DTANGENT_PROBE_NO_STAGING"),
                    "phases no products": ("-DTANGENT_PROBE_CLOCKS", "-DTANGENT_PROBE_NO_PRODUCTS")}


def _phases(lib, call, blocks):
    """Mean cycles between the phase stamps of the first `blocks` blocks
    (thread 0 of each) over one launch: 'a-b: cycles' for each stamp pair."""
    call(0)
    torch.cuda.synchronize()
    h = np.zeros((2048, 16), dtype=np.int64)
    if lib.tangent_probe_clocks(ctypes.c_void_p(h.ctypes.data)) != 0:
        raise RuntimeError("copying the phase stamps failed")
    a = h[:min(blocks, 2048)]
    last = int((a != 0).sum(axis=1).max())
    d = np.diff(a[:, :last], axis=1).mean(axis=0)
    return ", ".join(f"{i}-{i + 1}: {x:.0f}" for i, x in enumerate(d)) + f"; sum {d.sum():.0f}"


def _build_tangent(jobs):
    """Build {key: (source dir, name, nvcc flags)}, each with the headers of
    its directory, in parallel: {key: (library or None, nvcc output)}."""
    procs = {}
    for key, (src_dir, name, flags) in jobs.items():
        d = OUT / re.sub(r"[^A-Za-z0-9]+", "_", key)
        d.mkdir(parents=True, exist_ok=True)
        for f in Path(src_dir).glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / f"{name}.cu").write_text((Path(src_dir) / f"{name}.cu").read_text())
        procs[key] = (d / "lib.so", subprocess.Popen(
            [gk._nvcc(), *gk.NVCC_FLAGS, *flags, "-o", str(d / "lib.so"), str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, p) in procs.items():
        log = p.communicate()[0]
        built[key] = (so if p.returncode == 0 else None, log)
    return built


def _k1t_caller(lib, baseline, bufs, outs, B, n, dtype):
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn = lib.gj_tangent_f64 if dtype == torch.float64 else lib.gj_tangent_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    if baseline:
        fn.argtypes = [P, P, P, I, I, P]
        return lambda i: fn(bufs[i][0].data_ptr(), bufs[i][1].data_ptr(), outs[i].data_ptr(),
                            B, n, stream)
    plan = gk.gj_tangent_plan(B, n, dtype)
    fn.argtypes = [P, P, P, I, I, I, I, I, P]
    return lambda i: fn(bufs[i][0].data_ptr(), bufs[i][1].data_ptr(), outs[i].data_ptr(), B, n,
                        plan.np, plan.panel, plan.mb, stream)


def _k3t_caller(lib, baseline, bufs, touts, sizes, B, n, dtype):
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn = lib.dchain_tangent_f64 if dtype == torch.float64 else lib.dchain_tangent_f32
    P, I, PP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    csz = (ctypes.c_int * len(sizes))(*sizes)
    if baseline:
        fn.argtypes = [P, P, PP, PP, ctypes.POINTER(ctypes.c_int), I, I, I, P]
        ins = [(ctypes.c_void_p * len(o))(*(t.data_ptr() for t in o)) for _, _, o in bufs]
        out = [(ctypes.c_void_p * len(t))(*(x.data_ptr() for x in t)) for t in touts]
        return lambda i: fn(bufs[i][0].data_ptr(), bufs[i][1].data_ptr(), ins[i], out[i], csz,
                            len(sizes), B, n, stream)
    fn.argtypes = [P, P, PP, ctypes.POINTER(ctypes.c_int), I, I, I, P]
    ptrs = [(ctypes.c_void_p * (2 * len(o)))(*(x.data_ptr() for x in (*o, *t)))
            for (_, _, o), t in zip(bufs, touts)]
    return lambda i: fn(bufs[i][0].data_ptr(), bufs[i][1].data_ptr(), ptrs[i], csz, len(sizes),
                        B, n, stream)


def probe_tangent(baseline=None):
    jobs = {}
    if baseline:
        for name in ("gj_tangent", "dchain_tangent"):
            jobs[f"{name} baseline"] = (baseline, name, ())
    for name in ("gj_tangent", "dchain_tangent"):
        jobs[f"{name} shipped"] = (gk.CSRC, name, ())
        for v, flags in TANGENT_VARIANTS.items():
            jobs[f"{name} {v}"] = (gk.CSRC, name, flags)
    t0 = time.time()
    built = _build_tangent(jobs)
    print(f"built {len(built)} tangent libraries in {time.time() - t0:.1f} s")
    for key, (so, log) in built.items():
        if so is None:
            print(f"{key}: BUILD FAILED\n{log}")
            continue
        if key.endswith("shipped") or key.endswith("baseline"):
            for inst, regs, st, ld, frame in gk.ptxas_report(log):
                print(f"  ptxas {key} {inst}: {regs} registers, spill {st}/{ld} B, "
                      f"stack frame {frame} B")
    order = [k for k in jobs if k.endswith("baseline")]
    order = order + [k for k in jobs if k.endswith("shipped")] + \
        [k for k in jobs if not k.endswith(("shipped", "baseline"))] + \
        [k for k in jobs if k.endswith("shipped")] + order[::-1]
    libs = {k: ctypes.CDLL(str(so)) for k, (so, _) in built.items() if so is not None}

    rng = np.random.default_rng(0)
    for (B, n), dtype in TANGENT_K1_SHAPES:
        size = torch.empty(0, dtype=dtype).element_size()
        A = torch.as_tensor(rng.standard_normal((B, n, n)) + 20.0 * np.eye(n), device="cuda")
        X = torch.linalg.inv(_equilibrate(A)[0]).contiguous()
        rot = min(64, max(4, -(-60_000_000 // (2 * B * n * n * size))))
        bufs = [(X.to(dtype), torch.as_tensor(rng.standard_normal((B, n, n)), device="cuda")
                 .to(dtype)) for _ in range(rot)]
        outs = [torch.empty_like(b[0]) for b in bufs]
        ref = gk.gj_tangent_plain(bufs[0][0].double(), bufs[0][1].double())
        cells = []
        for key in order:
            if not key.startswith("gj_tangent") or key not in libs or "phases" in key:
                continue
            call = _k1t_caller(libs[key], key.endswith("baseline"), bufs, outs, B, n, dtype)
            if call(0) != 0:
                cells.append(f"{key}: launch failed")
                continue
            torch.cuda.synchronize()
            err = float((outs[0].double() - ref).abs().max() / ref.abs().max())
            cells.append(f"{key.split(' ', 1)[1]} {_spin_ms(call, rot):.4f} ms (err {err:.1e})")
        bmm = _spin_ms(lambda i: torch.bmm(torch.bmm(bufs[i][0], bufs[i][1]), bufs[i][0]), rot)
        plan = gk.gj_tangent_plan(B, n, dtype)
        for key in [k for k in libs if k.startswith("gj_tangent phases")]:
            lib = libs[key]
            cells.append(key.split(" ", 1)[1] + " (cycles, thread 0): " + _phases(
                lib, _k1t_caller(lib, False, bufs, outs, B, n, dtype), plan.blocks))
        print(f"K1t ({B}, {n}) {str(dtype)[6:]} [{plan.regime}: np {plan.np}, pr {plan.panel}, "
              f"mb {plan.mb}, {plan.blocks} blocks of {plan.threads}]: " + "; ".join(cells)
              + f"; two torch.bmm {bmm:.4f} ms")

    _, Dp, sizes, _ = newton_matrices()
    sizes = tuple(sizes)
    n = Dp.shape[-1]
    for B, dtype in TANGENT_K3_SHAPES:
        reps = -(-B // Dp.shape[0])
        rot = 64 if B <= 2 else 4
        bufs = []
        for i in range(rot):
            D = Dp.to("cuda", dtype).repeat(reps, 1, 1)[:B].contiguous()
            dD = (D * torch.as_tensor(rng.standard_normal(D.shape), device="cuda", dtype=dtype))
            bufs.append((D, dD.contiguous(), kd.dchain_cuda(D, sizes)))
        touts = [[torch.empty_like(o) for o in b[2]] for b in bufs]
        ref = kd.dchain_tangent_plain(bufs[0][0].double(), bufs[0][1].double(),
                                      [o.double() for o in bufs[0][2]], sizes)
        cells = []
        for key in order:
            if not key.startswith("dchain_tangent") or key not in libs or "phases" in key:
                continue
            call = _k3t_caller(libs[key], key.endswith("baseline"), bufs, touts, sizes, B, n,
                               dtype)
            if call(0) != 0:
                cells.append(f"{key}: launch failed")
                continue
            torch.cuda.synchronize()
            err = max(float((t.double() - r).abs().max() / r.abs().max())
                      for t, r in zip(touts[0], ref))
            cells.append(f"{key.split(' ', 1)[1]} {_spin_ms(call, rot):.4f} ms (err {err:.1e})")
        for key in [k for k in libs if k.startswith("dchain_tangent phases")]:
            lib = libs[key]
            cells.append(key.split(" ", 1)[1] + " (cycles, thread 0): " + _phases(
                lib, _k3t_caller(lib, False, bufs, touts, sizes, B, n, dtype), B))
        print(f"K3t ({B}, {n}) sizes {sizes} {str(dtype)[6:]} "
              f"[{kd.tangent_smem_bytes(n, sizes, dtype)} B a block, "
              f"{kd.tangent_blocks_per_sm(n, sizes, dtype)} an SM]: " + "; ".join(cells))


def _host_us(call, reps=200, rounds=5):
    """µs of host time a call of `call()`, over `rounds` loops of `reps`
    calls queued behind a spin kernel: (median, min, max) of the rounds."""
    call()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        per.append((time.perf_counter() - t0) * 1e6 / reps)
        torch.cuda.synchronize()
    return float(np.median(per)), min(per), max(per)


def probe_host():
    gk.compile_all(("dchain", "dchain_tangent"))
    _, Dp, sizes, _ = newton_matrices()
    sizes = tuple(sizes)
    for B, dtype in ((1, torch.float64), (1024, torch.float64), (1024, torch.float32)):
        D = Dp.to("cuda", dtype).repeat(-(-B // Dp.shape[0]), 1, 1)[:B].contiguous()
        dD = (D * 0.5).contiguous()
        outs = kd.dchain_cuda(D, sizes)
        _, shapes = kd.tangent_checked(D, dD, outs, sizes)
        touts = tuple(D.new_empty(s) for s in shapes)
        ptrs = kd.tangent_pointers(outs, touts)
        lib = gk.library("dchain_tangent", kd._T_LAUNCHERS)
        fn = lib.dchain_tangent_f64 if dtype == torch.float64 else lib.dchain_tangent_f32
        csz, stream = kd._c_sizes(sizes), gk._raw_stream(D.device)
        parts = {
            "checks": lambda: kd.tangent_checked(D, dD, outs, sizes),
            "7 allocations": lambda: tuple(D.new_empty(s) for s in shapes),
            "pointer array": lambda: kd.tangent_pointers(outs, touts),
            "bare ctypes launch": lambda: fn(D.data_ptr(), dD.data_ptr(), ptrs, csz, len(sizes),
                                             B, D.shape[1], stream),
            "launch with lookup and count": lambda: kd.tangent_launch(D, dD, ptrs, sizes),
            "whole wrapper": lambda: kd.dchain_tangent_cuda(D, dD, outs, sizes),
            "one PyTorch x.add_(1) (floor)": lambda: touts[0].add_(1),
        }
        print(f"K3t host µs a call ({B}, {D.shape[1]}) {str(dtype)[6:]}, median [min, max] of 5 "
              "loops of 200: " + "; ".join(
                  "{}: {:.1f} [{:.1f}, {:.1f}]".format(k, *_host_us(f)) for k, f in parts.items()))


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    tangent_baseline = None
    if "--tangent-baseline" in argv:
        tangent_baseline = argv[argv.index("--tangent-baseline") + 1]
        argv = [a for a in argv if a not in ("--tangent-baseline", tangent_baseline)]
    baseline = None
    if "--k2-baseline" in argv:
        baseline = argv[argv.index("--k2-baseline") + 1]
        argv = [a for a in argv if a not in ("--k2-baseline", baseline)]
    parts = argv or ["k1k3", "k2"]
    if "k1k3" in parts:
        probe_k1_k3()
    if "k2" in parts:
        probe_k2(baseline)
    if "tangent" in parts:
        probe_tangent(tangent_baseline)
    if "host" in parts:
        probe_host()


if __name__ == "__main__":
    main(sys.argv[1:])
