"""Batched Gauss-Jordan inverse: the CUDA kernel and its plain versions,
and the build of every CUDA kernel of the port.

Counterpart of the JAX package's ``ops/pallas_gj.py``. The TPU kernel
``_gj_kernel`` becomes ``csrc/gj_inverse.cu`` (CUDA C++ for sm_90a, one
thread block per matrix, the matrix in register tiles and inverted in place
by ``csrc/gj_common.cuh``; the sources say what bounds it and why it is
shaped so).

Every ``csrc/<name>.cu`` is compiled with ``nvcc`` into a shared library with
a plain C interface, at first use (or all together by ``compile_all``), into
``build/kernels/`` at the repository root, one library per source version,
and bound with ``ctypes`` (``library``); the version tag covers the source
and every shared ``csrc/*.cuh`` header. ``LAUNCHES`` counts the launches of
each kernel.

Beside the kernel live the plain PyTorch versions of the same function:
``gj_inverse`` (scalar pivot loop), ``gj_inverse_blocked`` (the JAX
package's ``linsolve.gj_inverse_blocked``) and ``gj_inverse_inplace`` (the
kernel's in-place pivot loop in its order of operations, which the tests and
``chip_smoke.py`` hold the kernel against). ``gj_inverse_hot`` dispatches on
the tensor's device: a CPU tensor takes the plain blocked version, a CUDA
tensor launches the kernel or raises — there is no fallback.

Forward-mode tangents (``ops/dual.py``): a dual input goes through
``Inverse``, an ``autograd.Function`` whose forward is the same dispatch and
whose ``jvp`` is dX = −X·dA·X, by ``csrc/gj_tangent.cu`` (K1ᵗ) for a CUDA
tensor and ``gj_tangent_plain`` for a CPU tensor. K1ᵗ replaces no TPU kernel
of its own: it is the port's counterpart of Pallas's JVP of ``_gj_kernel``,
which the JAX package's ``jax.jacfwd`` runs on a TPU. K2's tangent
(``ops/gj_blocks.py``) is the same kernel. ``gj_tangent_plan`` picks K1ᵗ's
launch from (B, n, dtype) in pure Python, and ``gj_tangent_mirror`` is K1ᵗ
in its order of operations, which the tests hold against the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import cost
from .dual import has_tangent, refuse

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNEL_SOURCES = ("gj_inverse", "gj_blocks", "dchain", "gj_tangent", "dchain_tangent")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# shared memory one block may use on Hopper (227 KB, opt-in above 48 KB)
MAX_SMEM_BYTES = 232448
# largest n the kernel's register tiles take (csrc/gj_inverse.cu max_n)
MAX_N = {torch.float32: 176, torch.float64: 128}

# launches of each kernel, and of each kernel by matrix size n, over every
# thread (a run split over devices counts each shard's); reset with
# reset_launch_counts()
LAUNCHES = {name: 0 for name in KERNEL_SOURCES}
LAUNCHES_BY_N = {name: {} for name in KERNEL_SOURCES}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts():
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            LAUNCHES_BY_N[k].clear()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gj_inverse(A):
    """Explicit inverse by pivot-free Gauss-Jordan, (..., n, n). Callers
    equilibrate first; the P2D blocks are diagonally dominant."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (n, n))
    M = torch.cat([A, eye], dim=-1)
    for k in range(n):
        piv = M[..., k, k]
        row = M[..., k, :] / piv[..., None]
        col = M[..., :, k]
        M = M - col[..., :, None] * row[..., None, :]
        M[..., k, :] = row
    return M[..., :, n:]


def gj_inverse_inplace(A, bs: int = 8):
    """Pivot-free Gauss-Jordan inverse formed in place, `bs` pivots at a
    time, (..., n, n): at bs = 8 the order of operations of the kernels
    (csrc/gj_common.cuh, for K1 and every inverse of K3).
    n is padded to a multiple of bs with an identity tail. For the pivot set
    K: P = the bs = 1 inverse of the pivot block, R = P·A[K, :],
    A ← A − A[:, K]·R, then A[K, :] = R, A[:, K] = −A[:, K]·P, A[K, K] = P.
    At bs = 1 this is the scalar loop (p = 1/a_kk; row a_kj·p; others
    a_ij − a_ik·(a_kj·p); column −a_ik·p; pivot p). The kernels sum each
    product chain in one fma chain; this version rounds products and sums
    apart (torch.matmul)."""
    n = A.shape[-1]
    n_pad = -(-n // bs) * bs
    M = torch.zeros(A.shape[:-2] + (n_pad, n_pad), dtype=A.dtype, device=A.device)
    M[..., :n, :n] = A
    pad = torch.arange(n, n_pad, device=A.device)
    M[..., pad, pad] = 1.0
    for c0 in range(0, n_pad, bs):
        K = slice(c0, c0 + bs)
        if bs == 1:
            P = 1.0 / M[..., K, K]
        else:
            P = gj_inverse_inplace(M[..., K, K], bs=1)
        R = torch.matmul(P, M[..., K, :])
        C = M[..., :, K].clone()
        M = M - torch.matmul(C, R)
        M[..., K, :] = R
        M[..., :, K] = -torch.matmul(C, P)
        M[..., K, K] = P
    return M[..., :n, :n]


def gj_inverse_blocked(A, bs: int = 8):
    """Blocked pivot-free Gauss-Jordan inverse (the plain version of the
    kernel). n is padded to a multiple of `bs` with an identity tail."""
    n = A.shape[-1]
    n_pad = ((n + bs - 1) // bs) * bs
    batch = A.shape[:-2]
    kw = dict(dtype=A.dtype, device=A.device)
    if n_pad != n:
        Ap = torch.zeros(batch + (n_pad, n_pad), **kw)
        Ap[..., :n, :n] = A
        pad = torch.arange(n, n_pad, device=A.device)
        Ap[..., pad, pad] = 1.0
        A = Ap
    m = n_pad
    M = torch.cat([A, torch.eye(m, **kw).expand(batch + (m, m))], dim=-1)
    eye_bs = torch.eye(bs, **kw)
    for kb in range(m // bs):
        c0, c1 = kb * bs, (kb + 1) * bs
        Drows = M[..., c0:c1, :]                      # (bs, 2m)
        Dblk = Drows[..., :, c0:c1]                   # (bs, bs)
        Dinv = gj_inverse(Dblk)
        R = torch.matmul(Dinv, Drows)                 # normalised rows
        # the pivot rows of C become (Dblk − I), so M − C·R also writes R
        # into the pivot rows: one pass over M per block
        C = M[..., :, c0:c1].clone()
        C[..., c0:c1, :] = Dblk - eye_bs
        M = M - torch.matmul(C, R)
    inv = M[..., :, m:]
    if n_pad != n:
        inv = inv[..., :n, :n]
    return inv


def _best_bs(n: int) -> int:
    """Block width minimising the blocked-GJ traffic ∝ passes·n_pad²."""
    def cost(bs):
        nb = -(-n // bs)
        return nb * (nb * bs) ** 2
    return min((32, 24, 16), key=cost)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

BUILD_LOGS: dict = {}     # source name -> nvcc output of its last build


def ptxas_report(log: str) -> list:
    """[(kernel instance (mangled), registers, spill store bytes, spill load
    bytes, stack frame bytes)] of every entry function in nvcc's
    ``-Xptxas -v`` output (a build log of ``BUILD_LOGS``), in its order."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            rows.setdefault(cur, [None, int(m.group(2)), int(m.group(3)), int(m.group(1))])
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in rows:
            rows[cur][0] = int(m.group(1))
    return [(name, *row) for name, row in rows.items()]
_libs: dict = {}
_BUILD_LOCK = threading.Lock()    # one build and load of a library at a time


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _so_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def compile_all(names=KERNEL_SOURCES):
    """Compile each named source whose library is not built yet: one nvcc
    per source, all started together. Raises if any build fails."""
    jobs = {}
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        jobs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in jobs.items():
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{CSRC / (n + '.cu')}:\n{BUILD_LOGS[n]}" for n in failed))


def library(name: str, launchers: dict):
    """The loaded library of ``csrc/<name>.cu`` (compiled at first use).
    `launchers` maps each exported launcher to its ctypes argument types;
    every launcher returns a cudaError_t code, and ``<name>_error_string``
    turns a code into text. Threads that ask together share one build."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        if name not in _libs:
            compile_all((name,))
            lib = ctypes.CDLL(str(_so_path(name)))
            for fn_name, argtypes in launchers.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def check_launch(lib, name: str, rc: int, n: int):
    """Raise if a launcher returned a CUDA error; count the launch, by the
    matrix size `n`, if not."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        LAUNCHES_BY_N[name][n] = LAUNCHES_BY_N[name].get(n, 0) + 1


_P, _I = ctypes.c_void_p, ctypes.c_int
_GJ_LAUNCHERS = {f"gj_inverse_{t}": [_P, _P, _I, _I, _P] for t in ("f32", "f64")}


def build():
    """Compile (once per source version) and load the K1 library."""
    return library("gj_inverse", _GJ_LAUNCHERS)


def gj_inverse_cuda(A):
    """Launch the kernel on a contiguous CUDA (B, n, n) f32/f64 tensor."""
    refuse("gj_inverse_cuda", A)
    if A.device.type != "cuda":
        raise ValueError(f"gj_inverse_cuda needs a CUDA tensor, got {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gj_inverse_cuda takes float32/float64, got {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"gj_inverse_cuda takes (B, n, n), got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("gj_inverse_cuda takes a contiguous tensor")
    B, n = A.shape[0], A.shape[1]
    if n > MAX_N[A.dtype]:
        raise ValueError(f"gj_inverse_cuda takes n <= {MAX_N[A.dtype]} in "
                         f"{A.dtype}, got n={n}")
    out = torch.empty_like(A)
    if B == 0 or n == 0:
        return out
    lib = build()
    fn = lib.gj_inverse_f32 if A.dtype == torch.float32 else lib.gj_inverse_f64
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(A.data_ptr(), out.data_ptr(), B, n, stream)
    check_launch(lib, "gj_inverse", rc, n)
    return out


@cost.counted("gj_inverse")
def _gj_inverse_dispatch(A):
    n = A.shape[-1]
    if A.device.type == "cpu":
        return gj_inverse_blocked(A, bs=_best_bs(n))
    flat = A.reshape(-1, n, n).contiguous()
    return gj_inverse_cuda(flat).reshape(A.shape)


def gj_inverse_hot(A):
    """(..., n, n) inverses of equilibrated matrices: the kernel for a CUDA
    tensor, the plain blocked version for a CPU tensor; a dual `A` through
    ``Inverse`` (its tangent by K1ᵗ on the card)."""
    if has_tangent(A):
        return Inverse.apply(A, _gj_inverse_dispatch)
    return _gj_inverse_dispatch(A)


# ---------------------------------------------------------------------------
# the tangent: K1ᵗ and its plain version
# ---------------------------------------------------------------------------

_GJT_LAUNCHERS = {f"gj_tangent_{t}": [_P, _P, _P, _I, _I, _I, _I, _I, _P]
                  for t in ("f32", "f64")}

# K1ᵗ's launch plan (csrc/gj_tangent.cu). A matrix is padded to the first of
# TANGENT_NP that holds it (zeros staged at no cost in device memory).
SM_COUNT = 132              # SMs of an H100 SXM: the small-batch threshold
TANGENT_PANEL = 16          # rows of a panel in the small-batch regime
TANGENT_SMALL_THREADS = 512  # threads of its blocks (csrc/gj_tangent.cu kSmallThreads)
TANGENT_NP = {torch.float32: (16, 32, 48, 72, 96, 128, 176),
              torch.float64: (16, 32, 48, 72, 96, 128)}
# large-batch regime: (rows of a panel, matrices a block) at each padded size;
# a panel is the whole matrix where two of them fit a block's 227 KB
_TANGENT_LARGE = {
    torch.float32: {16: (16, 16), 32: (32, 4), 48: (48, 2), 72: (72, 1), 96: (96, 1),
                    128: (128, 1), 176: (88, 1)},
    torch.float64: {16: (16, 4), 32: (32, 2), 48: (48, 1), 72: (72, 1), 96: (96, 1),
                    128: (64, 1)},
}


@dataclasses.dataclass(frozen=True)
class TangentPlan:
    """A K1ᵗ launch: regime ("small": a block a panel of 16 rows, for batches
    that leave SMs idle; "large": a block a matrix, or MB of them), padded
    size np, rows of a panel, matrices a block mb, panels a matrix, blocks,
    threads a block, dynamic shared memory a block (bytes) and whether X
    gets a third buffer (staged beside dA) or is staged over dA after the
    first product; rows: the rows of a panel's buffers (float64 tiles take
    16 rows, zeros past n)."""
    regime: str
    np: int
    panel: int
    rows: int
    mb: int
    panels: int
    blocks: int
    threads: int
    smem: int
    three: bool


def _col_tiles(np_: int) -> int:
    """Largest divisor of np / 8 that is at most 4: a float64 warp's tiles."""
    c = np_ // 8
    return next(d for d in (4, 3, 2, 1) if c % d == 0)


@functools.lru_cache(maxsize=None)
def gj_tangent_plan(B: int, n: int, dtype: torch.dtype) -> TangentPlan:
    """K1ᵗ's launch for B matrices of size n: the small-batch regime where
    B·⌈n/16⌉ ≤ SM_COUNT (every panel a block, one wave), the large-batch
    regime above it. Pure Python: the wrapper passes (np, panel, mb) to the
    kernel, which has one instance for each pair this returns."""
    if not 1 <= n <= MAX_N[dtype]:
        raise ValueError(f"gj_tangent takes 1 <= n <= {MAX_N[dtype]} in {dtype}, got {n}")
    np_ = next(p for p in TANGENT_NP[dtype] if p >= n)
    small = B * -(-n // TANGENT_PANEL) <= SM_COUNT
    panel, mb = (min(TANGENT_PANEL, np_), 1) if small else _TANGENT_LARGE[dtype][np_]
    size = dtype.itemsize
    ld = np_ + 4
    rp = -(-panel // 16) * 16 if dtype == torch.float64 else panel   # 16-row MMA tiles
    three = panel != np_ and (rp + 2 * np_) * ld * size * mb <= MAX_SMEM_BYTES
    smem = (rp + max(np_, rp) + (np_ if three else 0)) * ld * mb * size
    if small and panel == TANGENT_PANEL:
        threads = TANGENT_SMALL_THREADS
    elif dtype == torch.float64:
        threads = 32 * min(8, mb * (rp // 16) * (np_ // 8 // _col_tiles(np_)))
    else:
        # float32 thread tiles of 4 rows x 8 columns (csrc/gj_tangent.cu kRowsF32)
        threads = -(-(mb * (panel // 4) * (np_ // 8)) // 32) * 32
    panels = -(-n // panel)
    return TangentPlan("small" if small else "large", np_, panel, rp, mb, panels,
                       -(-B // mb) * panels, threads, smem, three)


def gj_tangent_plain(X, dA):
    """dX = −(X·dA)·X, the tangent of X = A⁻¹ along dA, (..., n, n) (the
    kernel's association)."""
    return -torch.matmul(torch.matmul(X, dA), X)


def _sum_in_steps(A, B, acc=None, step=8):
    """acc + A·B with the depth taken `step` at a time, each step's sum added
    to the running sum (a DMMA m16n8k8 step); acc None: zero."""
    if acc is None:
        acc = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=A.dtype, device=A.device)
    for k in range(0, A.shape[-1], step):
        acc = acc + torch.matmul(A[..., k:k + step], B[..., k:k + step, :])
    return acc


def gj_tangent_mirror(X, dA):
    """K1ᵗ in its order of operations (csrc/gj_tangent.cu), (B, n, n): X and
    dA padded with zeros to the plan's np, then for each panel of the plan's rows
    V = X[panel, :]·dA and dX[panel, :] = −V·X, each product summing the
    depth eight at a time as the float64 kernel's DMMA does (the float32
    kernel sums it one term at a time in an fma chain)."""
    B, n = X.shape[0], X.shape[-1]
    plan = gj_tangent_plan(B, n, X.dtype)
    Xp = X.new_zeros((B, plan.np, plan.np))
    dAp = X.new_zeros((B, plan.np, plan.np))
    Xp[:, :n, :n] = X
    dAp[:, :n, :n] = dA
    out = torch.empty_like(X)
    for r0 in range(0, n, plan.panel):
        V = _sum_in_steps(Xp[:, r0:r0 + plan.panel], dAp)
        out[:, r0:r0 + plan.panel] = -_sum_in_steps(V, Xp)[:, :n - r0, :n]
    return out


def _gjt_library():
    lib = library("gj_tangent", _GJT_LAUNCHERS)
    fn = lib.gj_tangent_block
    if fn.restype is not ctypes.c_longlong:
        fn.argtypes, fn.restype = [_I] * 5, ctypes.c_longlong
    return lib


def gj_tangent_block(plan: TangentPlan, dtype: torch.dtype):
    """(shared memory bytes, threads) of the kernel instance the plan names,
    as the compiled source computes them (None where it has no such
    instance): chip_smoke.py and the card tests hold the plan to them."""
    fn = _gjt_library().gj_tangent_block
    f64 = int(dtype == torch.float64)
    smem = fn(f64, plan.np, plan.panel, plan.mb, 0)
    return None if smem < 0 else (smem, fn(f64, plan.np, plan.panel, plan.mb, 1))


def _raw_stream(device) -> int:
    """The current CUDA stream of `device` as an int, without building a
    Stream object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_SAME_DEVICE = contextlib.nullcontext()


def on_device(device):
    """A context that makes `device` the current CUDA device (a launcher
    launches on the current one); nothing to switch where it already is."""
    if device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def gj_tangent_cuda(X, dA):
    """Launch K1ᵗ on contiguous CUDA (B, n, n) f32/f64 tensors: X an inverse,
    dA the tangent of the matrix it inverts."""
    refuse("gj_tangent_cuda", X, dA)
    if X.device.type != "cuda" or dA.device != X.device:
        raise ValueError(f"gj_tangent_cuda needs CUDA tensors on one device, got "
                         f"{X.device}, {dA.device}")
    if X.dtype not in (torch.float32, torch.float64) or dA.dtype != X.dtype:
        raise TypeError(f"gj_tangent_cuda takes float32/float64, got {X.dtype}, {dA.dtype}")
    if X.ndim != 3 or X.shape[1] != X.shape[2] or dA.shape != X.shape:
        raise ValueError(f"gj_tangent_cuda takes two (B, n, n), got {tuple(X.shape)}, "
                         f"{tuple(dA.shape)}")
    if not (X.is_contiguous() and dA.is_contiguous()):
        raise ValueError("gj_tangent_cuda takes contiguous tensors")
    B, n = X.shape[0], X.shape[1]
    if n > MAX_N[X.dtype]:
        raise ValueError(f"gj_tangent_cuda takes n <= {MAX_N[X.dtype]} in "
                         f"{X.dtype}, got n={n}")
    out = torch.empty_like(X)
    if B == 0 or n == 0:
        return out
    plan = gj_tangent_plan(B, n, X.dtype)
    lib = _gjt_library()
    fn = lib.gj_tangent_f32 if X.dtype == torch.float32 else lib.gj_tangent_f64
    with on_device(X.device):
        rc = fn(X.data_ptr(), dA.data_ptr(), out.data_ptr(), B, n, plan.np, plan.panel,
                plan.mb, _raw_stream(X.device))
    check_launch(lib, "gj_tangent", rc, n)
    return out


@cost.counted("gj_tangent")
def gj_tangent_hot(X, dA):
    """The tangent of (..., n, n) inverses: K1ᵗ for CUDA tensors, the plain
    version for CPU tensors."""
    if X.device.type == "cpu":
        return gj_tangent_plain(X, dA)
    n = X.shape[-1]
    return gj_tangent_cuda(X.reshape(-1, n, n).contiguous(),
                           dA.reshape(-1, n, n).contiguous()).reshape(X.shape)


class Inverse(torch.autograd.Function):
    """X = inverse(A) by `inverse` (a hot dispatch: K1, K2 or their plain
    versions) with the forward-mode tangent dX = −X·dA·X (K1ᵗ on the card).
    Forward mode only, as ``jax.jacfwd``: backward raises."""

    @staticmethod
    def forward(A, inverse):
        X = inverse(A)
        # an output that is a view (the plain versions' slices) cannot take a
        # tangent of its own
        return X if X._base is None else X.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, dA, _):
        (X,) = ctx.saved_tensors
        return gj_tangent_hot(X, dA)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("the kernels' inverses take forward mode only")
