"""Gauss-Jordan inverses of stacks of small matrices: K2, the CUDA kernel,
and its plain version.

Counterpart of the JAX package's ``ops/pallas_gj.py:gj_inverse_hot_blocks``
(the same TPU kernel ``_gj_kernel`` over a (B, m, n, n) stack flattened to
B·m matrices). On the card it is ``csrc/gj_blocks.cu``: lane i of a group
holds row i of a matrix in registers, several matrices a warp, n ≤ 32 (the
source says what bounds it). The nested Schur factorization sends its
group inverses here (particle blocks n = 10, the c_e block n = 30) when the
route asks for blocks.

The plain version is the scalar pivot-free Gauss-Jordan
(``gj_kernel.gj_inverse``), which is what the JAX package's
``structured._gj_inverse_routed`` runs off the TPU. ``gj_blocks_hot`` takes
it for a CPU tensor; a CUDA tensor launches the kernel or raises.
``gj_blocks_mirror`` is the kernel's own order of operations, which the
tests and ``chip_smoke.py`` hold the kernel against. A dual input (forward
mode, ``ops/dual.py``) goes through ``gj_kernel.Inverse``: its tangent is
K1ᵗ (``csrc/gj_tangent.cu``) at n = 10 and 30 on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cost
from .dual import has_tangent, refuse
from .gj_kernel import Inverse, check_launch, gj_inverse, library

MAX_N = 32          # one row per lane of a warp (csrc/gj_blocks.cu kMaxN)

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCHERS = {f"gj_blocks_{t}": [_P, _P, _I, _I, _P] for t in ("f32", "f64")}


def build():
    """Compile (once per source version) and load the K2 library."""
    return library("gj_blocks", _LAUNCHERS)


def gj_blocks_plain(A):
    """Inverses of a (..., n, n) stack of equilibrated matrices."""
    return gj_inverse(A)


def kernel_width(n: int) -> int:
    """Rows and columns the kernel holds for an n×n matrix
    (csrc/gj_blocks.cu launch): n itself at the main path's 10 and 30, else
    8, 16 or 32, the matrix padded with an identity tail."""
    return n if n in (10, 30) else 8 if n <= 8 else 16 if n <= 16 else 32


def gj_blocks_mirror(A, width=None):
    """K2's order of operations in plain PyTorch, (..., n, n): the matrix
    padded with an identity tail to `width` (default ``kernel_width(n)``;
    exact: the inverse restricts), inverted in place one pivot at a time
    with each pivot row's scaling deferred to the end. For pivot k, with
    p = 1/a_kk and the raw row a_k*: every other row i takes m_i = a_ik·p,
    a_ij ← a_ij − m_i·a_kj (j ≠ k) and a_ik ← −m_i; row k keeps its raw
    values with a_kk ← 1. Each row is the exact inverse's row divided by its
    own p, so the end multiplies row i by p_i. The kernel fuses each update
    into one fma; this version rounds the product and the difference apart."""
    n = A.shape[-1]
    w = kernel_width(n) if width is None else width
    M = torch.zeros(A.shape[:-2] + (w, w), dtype=A.dtype, device=A.device)
    M[..., :n, :n] = A
    pad = torch.arange(n, w, device=A.device)
    M[..., pad, pad] = 1.0
    p_all = torch.empty(A.shape[:-2] + (w,), dtype=A.dtype, device=A.device)
    for k in range(w):
        row = M[..., k, :].clone()
        p = 1.0 / row[..., k]
        p_all[..., k] = p
        m = M[..., :, k] * p[..., None]
        m[..., k] = 0.0
        row[..., k] = 1.0
        M[..., :, k] = 0.0
        M[..., k, k] = 1.0
        M = M - m[..., :, None] * row[..., None, :]
    return (M * p_all[..., :, None])[..., :n, :n]


def gj_blocks_cuda(A):
    """Launch K2 on a contiguous CUDA (M, n, n) f32/f64 tensor."""
    refuse("gj_blocks_cuda", A)
    if A.device.type != "cuda":
        raise ValueError(f"gj_blocks_cuda needs a CUDA tensor, got {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gj_blocks_cuda takes float32/float64, got {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"gj_blocks_cuda takes (M, n, n), got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("gj_blocks_cuda takes a contiguous tensor")
    M, n = A.shape[0], A.shape[1]
    if n > MAX_N:
        raise ValueError(f"gj_blocks_cuda takes n <= {MAX_N}, got {n}")
    out = torch.empty_like(A)
    if M == 0 or n == 0:
        return out
    lib = build()
    fn = lib.gj_blocks_f32 if A.dtype == torch.float32 else lib.gj_blocks_f64
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(A.data_ptr(), out.data_ptr(), M, n, stream)
    check_launch(lib, "gj_blocks", rc, n)
    return out


@cost.counted("gj_blocks")
def _gj_blocks_dispatch(A):
    if A.device.type == "cpu":
        return gj_blocks_plain(A)
    n = A.shape[-1]
    return gj_blocks_cuda(A.reshape(-1, n, n).contiguous()).reshape(A.shape)


def gj_blocks_hot(A):
    """(..., n, n) inverses of equilibrated matrices: K2 for a CUDA tensor,
    the plain version for a CPU tensor; a dual `A` through
    ``gj_kernel.Inverse`` (its tangent by K1ᵗ on the card)."""
    if has_tangent(A):
        return Inverse.apply(A, _gj_blocks_dispatch)
    return _gj_blocks_dispatch(A)
