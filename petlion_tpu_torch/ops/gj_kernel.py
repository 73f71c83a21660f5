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
(``ops/gj_blocks.py``) is the same kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

_GJT_LAUNCHERS = {f"gj_tangent_{t}": [_P, _P, _P, _I, _I, _P] for t in ("f32", "f64")}


def gj_tangent_plain(X, dA):
    """dX = −(X·dA)·X, the tangent of X = A⁻¹ along dA, (..., n, n) (the
    kernel's association)."""
    return -torch.matmul(torch.matmul(X, dA), X)


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
    lib = library("gj_tangent", _GJT_LAUNCHERS)
    fn = lib.gj_tangent_f32 if X.dtype == torch.float32 else lib.gj_tangent_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(X.data_ptr(), dA.data_ptr(), out.data_ptr(), B, n, stream)
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
