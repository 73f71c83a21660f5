"""The fused nested Schur chain on the permuted core: K3, the CUDA kernel,
and its plain version.

Counterpart of the JAX package's ``ops/pallas_schur.py`` (``_dchain_kernel``
via ``dchain_pallas`` / ``make_dchain_hot``). After the group eliminations
the Schur core D is permuted so that each nested level is a leading block
(``structured.make_sparse_specs`` computes the permutation and the level
sizes). For each level of size nk the chain computes, on the current core
[A B; C D22]: invA (the equilibrated inverse of A, scalings folded back),
AinvB = invA·B and D ← D22 − C·AinvB; then the folded equilibrated inverse
of what is left. Outputs, per level: invA (B, nk, nk), AinvB (B, nk, r),
C (B, r, nk); then the core inverse (B, r_last, r_last).

On the card it is ``csrc/dchain.cu``: one thread block per cell, the whole
core in shared memory through every level, each inverse by K1's
register-tiled elimination (the source says what bounds it).
``dchain_plain`` follows ``_dchain_kernel`` step by step with batched torch
operations; ``dchain_hot`` takes it for a CPU tensor, and a CUDA tensor
launches the kernel or raises. ``dchain_mirror`` is the same chain in the
kernel's order of operations (reciprocal scalings, the in-place
Gauss-Jordan), which the tests and ``chip_smoke.py`` hold the kernel
against.

Forward-mode tangents (``ops/dual.py``): a dual core goes through ``Chain``,
an ``autograd.Function`` whose forward is the same dispatch and whose
``jvp`` is the chain's tangent: ``csrc/dchain_tangent.cu`` (K3ᵗ, one thread
block a cell) for a CUDA tensor, ``dchain_tangent_plain`` for a CPU tensor.
K3ᵗ replaces no TPU kernel of its own: it is the port's counterpart of
Pallas's JVP of ``_dchain_kernel``, which the JAX package's ``jax.jacfwd``
runs on a TPU. ``dchain_tangent_mirror`` is K3ᵗ in its order of operations
(its cores updated in place), and ``tangent_smem_bytes`` its shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cost
from .dual import has_tangent, primal, refuse
from .gj_kernel import (MAX_SMEM_BYTES, _raw_stream, _sum_in_steps, check_launch,
                        gj_inverse, gj_inverse_inplace, gj_tangent_plain, library,
                        on_device)

MAX_LEVELS = 4      # csrc/dchain.cu kMaxLevels
# largest inverse of the chain the kernel takes (csrc/dchain.cu max_m)
MAX_M = {torch.float32: 144, torch.float64: 112}

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCHERS = {f"dchain_{t}": [_P, ctypes.POINTER(ctypes.c_void_p),
                              ctypes.POINTER(ctypes.c_int), _I, _I, _I, _P]
              for t in ("f32", "f64")}


def build():
    """Compile (once per source version) and load the K3 library."""
    return library("dchain", _LAUNCHERS)


def inv_equil(A, invert=gj_inverse):
    """Row/col-equilibrated explicit inverse with the scalings folded back
    (the JAX package's ``pallas_schur._inv_equil``): equilibrate columns,
    then rows, invert pivot-free with `invert`, and fold
    ``inv_s / col[:, None] / row[None, :]``, since
    A = diag(row)·As·diag(col)  ⇒  A⁻¹ = diag(1/col)·As⁻¹·diag(1/row)."""
    colA = torch.clamp_min(A.abs().amax(dim=-2), 1e-30)
    As = A / colA[..., None, :]
    rowA = torch.clamp_min(As.abs().amax(dim=-1), 1e-30)
    As = As / rowA[..., :, None]
    return invert(As) / colA[..., :, None] / rowA[..., None, :]


def inv_equil_inplace(A):
    """``inv_equil`` in the kernel's order of operations: reciprocal
    scalings rc = 1/col and rr = 1/row, As = (A·rc)·rr, K1's in-place
    Gauss-Jordan eight pivots at a time, and the fold (inv_s·rc_i)·rr_j."""
    rc = 1.0 / torch.clamp_min(A.abs().amax(dim=-2), 1e-30)
    As = A * rc[..., None, :]
    rr = 1.0 / torch.clamp_min(As.abs().amax(dim=-1), 1e-30)
    As = As * rr[..., :, None]
    return gj_inverse_inplace(As) * rc[..., :, None] * rr[..., None, :]


out_shapes = cost.chain_shapes     # per-cell shapes of the outputs, in order


def dchain_plain(D, sizes, inverse=inv_equil):
    """The chain on a (B, n, n) permuted core, batched torch operations;
    `inverse` forms each level's and the rest's folded inverse."""
    outs = []
    for nk in sizes:
        A, Bm, C = D[:, :nk, :nk], D[:, :nk, nk:], D[:, nk:, :nk]
        invA = inverse(A)
        AinvB = torch.matmul(invA, Bm)
        D = D[:, nk:, nk:] - torch.matmul(C, AinvB)
        outs += [invA, AinvB, C.contiguous()]
    outs.append(inverse(D))
    return tuple(outs)


def dchain_mirror(D, sizes):
    """The chain in the kernel's order of operations."""
    return dchain_plain(D, sizes, inverse=inv_equil_inplace)


def _inverse_sizes(n: int, sizes) -> list:
    """Sizes of the chain's inverses: each level, then the rest."""
    return list(sizes) + [n - sum(sizes)]


def smem_bytes(n: int, sizes, dtype: torch.dtype) -> int:
    """Shared memory of one block (csrc/dchain.cu launch_plan): the pivot
    buffers of the tile grid the largest inverse takes, sharing room with
    the AinvB panel; the core; the scalings."""
    m, panel = n, 1
    for nk in sizes:
        panel = max(panel, nk * (m - nk))
        m -= nk
    big = max(_inverse_sizes(n, sizes))
    T, P = (8, 4) if big <= 32 else (16, 4) if big <= 64 else (16, 7) if big <= 112 else (16, 9)
    pivot_buffers = 4 * T * P * 12 + (T * T // 32) * 64     # gj_common.cuh smem_elems
    return (max(panel, pivot_buffers) + n * n + 2 * n) * dtype.itemsize


def check_sizes(n: int, sizes, dtype: torch.dtype):
    """Raise ValueError unless K3 takes a core of size n with these level
    sizes in `dtype`."""
    if len(sizes) > MAX_LEVELS or any(s < 1 for s in sizes) or sum(sizes) >= n:
        raise ValueError(f"dchain_cuda: level sizes {sizes} do not fit n={n}")
    if max(_inverse_sizes(n, sizes)) > MAX_M[dtype]:
        raise ValueError(f"dchain_cuda: inverses of sizes {_inverse_sizes(n, sizes)} "
                         f"exceed {MAX_M[dtype]} in {dtype}")
    if smem_bytes(n, sizes, dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"dchain_cuda: n={n} in {dtype} needs "
                         f"{smem_bytes(n, sizes, dtype)} B of shared memory")


def dchain_cuda(D, sizes):
    """Launch K3 on a contiguous CUDA (B, n, n) f32/f64 permuted core."""
    refuse("dchain_cuda", D)
    if D.device.type != "cuda":
        raise ValueError(f"dchain_cuda needs a CUDA tensor, got {D.device}")
    if D.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dchain_cuda takes float32/float64, got {D.dtype}")
    if D.ndim != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"dchain_cuda takes (B, n, n), got {tuple(D.shape)}")
    if not D.is_contiguous():
        raise ValueError("dchain_cuda takes a contiguous tensor")
    sizes = tuple(int(s) for s in sizes)
    B, n = D.shape[0], D.shape[1]
    check_sizes(n, sizes, D.dtype)
    outs = tuple(torch.empty((B,) + s, dtype=D.dtype, device=D.device)
                 for s in out_shapes(n, sizes))
    if B == 0:
        return outs
    lib = build()
    fn = lib.dchain_f32 if D.dtype == torch.float32 else lib.dchain_f64
    ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    csizes = (ctypes.c_int * max(len(sizes), 1))(*sizes)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(D.data_ptr(), ptrs, csizes, len(sizes), B, n, stream)
    check_launch(lib, "dchain", rc, n)
    return outs


@cost.counted("dchain")
def _dchain_dispatch(D, sizes):
    if D.device.type == "cpu":
        return dchain_plain(D, sizes)
    return dchain_cuda(D.contiguous(), sizes)


def dchain_hot(D, sizes):
    """The chain on a (B, n, n) permuted core: K3 for a CUDA tensor, the
    plain version for a CPU tensor; a dual `D` through ``Chain`` (its
    tangent by K3ᵗ on the card)."""
    if has_tangent(D):
        return Chain.apply(D, tuple(int(s) for s in sizes))
    return _dchain_dispatch(D, sizes)


# ---------------------------------------------------------------------------
# the tangent: K3ᵗ and its plain version
# ---------------------------------------------------------------------------

_T_LAUNCHERS = {f"dchain_tangent_{t}": [_P, _P, ctypes.POINTER(ctypes.c_void_p),
                                        ctypes.POINTER(ctypes.c_int), _I, _I, _I, _P]
                for t in ("f32", "f64")}
TANGENT_THREADS = 256       # csrc/dchain_tangent.cu NT
SM_SMEM_BYTES = 233472      # shared memory of an H100 SM
BLOCK_RESERVED_BYTES = 1024  # reserved by the system for each resident block
MAX_THREADS_PER_SM = 2048


def dchain_tangent_plain(D, dD, outs, sizes):
    """The chain's tangent along dD, (B, n, n), from the core D and the
    chain's outputs `outs` (in ``out_shapes`` order); per level of the
    current core [A B; C D22] and its tangent [dA dB; dC dD22]:
    d invA = −(invA·dA)·invA, d AinvB = d invA·B + invA·dB, dC, then
    dD ← dD22 − (dC·AinvB + C·d AinvB) and D ← D22 − C·AinvB; last the
    core inverse's −(X·dD)·X. The tangents come in the outputs' order."""
    touts = []
    M, dM = D, dD
    for L, nk in enumerate(sizes):
        invA, AinvB = outs[3 * L], outs[3 * L + 1]
        C, dA, dC = M[:, nk:, :nk], dM[:, :nk, :nk], dM[:, nk:, :nk]
        dinvA = gj_tangent_plain(invA, dA)
        dAinvB = torch.matmul(dinvA, M[:, :nk, nk:]) + torch.matmul(invA, dM[:, :nk, nk:])
        dM = dM[:, nk:, nk:] - (torch.matmul(dC, AinvB) + torch.matmul(C, dAinvB))
        M = M[:, nk:, nk:] - torch.matmul(C, AinvB)
        touts += [dinvA, dAinvB, dC.contiguous()]
    touts.append(gj_tangent_plain(outs[-1], dM))
    return tuple(touts)


def dchain_tangent_mirror(D, dD, outs, sizes):
    """K3ᵗ in its order of operations (csrc/dchain_tangent.cu): the primal
    and tangent cores held whole and updated in place a level at a time,
    T1 = invA·dA written over the primal core's A block and d invA over the
    tangent core's, the two r×r updates of a level in one pass, every
    product summing its depth eight at a time (the float64 kernel's DMMA
    steps; the float32 kernel sums one term at a time), d AinvB and the
    tangent's update each one running sum over both of their products."""
    Mp, dM = D.clone(), dD.clone()
    touts, o = [], 0
    for L, nk in enumerate(sizes):
        invA, AinvB = outs[3 * L], outs[3 * L + 1]
        e = o + nk
        Mp[:, o:e, o:e] = _sum_in_steps(invA, dM[:, o:e, o:e])                  # T1
        dM[:, o:e, o:e] = -_sum_in_steps(Mp[:, o:e, o:e], invA)                 # d invA
        dAB = _sum_in_steps(invA, dM[:, o:e, e:],
                            _sum_in_steps(dM[:, o:e, o:e], Mp[:, o:e, e:]))
        touts += [dM[:, o:e, o:e].clone(), dAB, dM[:, e:, o:e].clone()]
        upd = _sum_in_steps(Mp[:, e:, o:e], dAB, _sum_in_steps(dM[:, e:, o:e], AinvB))
        if L + 1 < len(sizes):
            Mp[:, e:, e:] = Mp[:, e:, e:] - _sum_in_steps(Mp[:, e:, o:e], AinvB)
        dM[:, e:, e:] = dM[:, e:, e:] - upd
        o = e
    T1 = _sum_in_steps(outs[-1], dM[:, o:, o:])
    touts.append(-_sum_in_steps(T1, outs[-1]))
    return tuple(touts)


def _pad_ld(cols: int) -> int:
    """Row stride of a shared operand (csrc/tangent_common.cuh pad_ld): 4 mod
    8 elements."""
    return cols + (4 - cols) % 8


def tangent_smem_bytes(n: int, sizes, dtype: torch.dtype) -> int:
    """Shared memory of one K3ᵗ block (csrc/dchain_tangent.cu plan_layout):
    the primal and tangent cores (n rows of the padded stride), the largest
    invA or core inverse X, and the largest AinvB twice (AinvB, d AinvB)."""
    s = dtype.itemsize
    m, s_inv, s_ab = n, 1, 1
    for nk in sizes:
        r = m - nk
        s_inv, s_ab = max(s_inv, nk * _pad_ld(nk)), max(s_ab, nk * _pad_ld(r))
        m = r
    s_inv = max(s_inv, m * _pad_ld(m))
    return (2 * n * _pad_ld(n) + s_inv + 2 * s_ab) * s


def tangent_blocks_per_sm(n: int, sizes, dtype: torch.dtype) -> int:
    """K3ᵗ blocks that fit one SM by shared memory and threads (its launch
    bounds ask the compiler for registers enough for two)."""
    by_smem = SM_SMEM_BYTES // (tangent_smem_bytes(n, sizes, dtype) + BLOCK_RESERVED_BYTES)
    return min(by_smem, MAX_THREADS_PER_SM // TANGENT_THREADS)


_C_SIZES = {}       # level sizes -> their ctypes array


def _c_sizes(sizes):
    arr = _C_SIZES.get(sizes)
    if arr is None:
        arr = _C_SIZES[sizes] = (ctypes.c_int * max(len(sizes), 1))(*sizes)
    return arr


def tangent_checked(D, dD, outs, sizes):
    """The checks of ``dchain_tangent_cuda`` on its arguments (it raises on
    any that K3ᵗ cannot take): (level sizes, the tangent outputs' shapes)."""
    refuse("dchain_tangent_cuda", D, dD, *outs)
    sizes = tuple(int(s) for s in sizes)
    dev, dtype = D.device, D.dtype
    if dev.type != "cuda" or dD.device != dev:
        raise ValueError(f"dchain_tangent_cuda needs CUDA tensors on one device, got "
                         f"{dev}, {dD.device}")
    if dtype not in (torch.float32, torch.float64) or dD.dtype != dtype:
        raise TypeError(f"dchain_tangent_cuda takes float32/float64, got {dtype}, "
                        f"{dD.dtype}")
    if D.ndim != 3 or D.shape[1] != D.shape[2] or dD.shape != D.shape:
        raise ValueError(f"dchain_tangent_cuda takes two (B, n, n), got "
                         f"{tuple(D.shape)}, {tuple(dD.shape)}")
    shapes = _tangent_shapes(D.shape[0], D.shape[1], sizes, dtype)
    if len(outs) != len(shapes) or any(
            o.shape != s or o.dtype != dtype or o.device != dev or not o.is_contiguous()
            for o, s in zip(outs, shapes)):
        raise ValueError("dchain_tangent_cuda: the chain's outputs do not match the core "
                         "(contiguous, its shapes, dtype and device)")
    if not (D.is_contiguous() and dD.is_contiguous()):
        raise ValueError("dchain_tangent_cuda takes contiguous tensors")
    return sizes, shapes


def tangent_pointers(outs, touts):
    """The launch's host array of device pointers: K3's outputs, then their
    tangents."""
    return (ctypes.c_void_p * (2 * len(outs)))(*[x.data_ptr() for x in (*outs, *touts)])


def tangent_launch(D, dD, ptrs, sizes):
    """Launch K3ᵗ on checked arguments, the outputs' pointers in `ptrs`."""
    lib = library("dchain_tangent", _T_LAUNCHERS)
    fn = lib.dchain_tangent_f32 if D.dtype == torch.float32 else lib.dchain_tangent_f64
    with on_device(D.device):
        rc = fn(D.data_ptr(), dD.data_ptr(), ptrs, _c_sizes(sizes), len(sizes), D.shape[0],
                D.shape[1], _raw_stream(D.device))
    check_launch(lib, "dchain_tangent", rc, D.shape[1])


def dchain_tangent_cuda(D, dD, outs, sizes):
    """Launch K3ᵗ on contiguous CUDA (B, n, n) f32/f64 tensors: the permuted
    core D, its tangent dD and K3's outputs `outs`. Its host parts (checks,
    the seven allocations, the pointer array, the launch) are the functions
    that ``kernel_probe host`` times one at a time."""
    sizes, shapes = tangent_checked(D, dD, outs, sizes)
    touts = tuple(D.new_empty(s) for s in shapes)
    if D.shape[0] == 0:
        return touts
    tangent_launch(D, dD, tangent_pointers(outs, touts), sizes)
    return touts


@functools.lru_cache(maxsize=None)
def _tangent_shapes(B: int, n: int, sizes: tuple, dtype: torch.dtype) -> tuple:
    """The tangent outputs' shapes for B cores of size n, after the checks
    that K3ᵗ takes the level sizes (ValueError otherwise)."""
    if len(sizes) > MAX_LEVELS or any(s < 1 for s in sizes) or sum(sizes) >= n:
        raise ValueError(f"dchain_tangent_cuda: level sizes {sizes} do not fit n={n}")
    if tangent_smem_bytes(n, sizes, dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"dchain_tangent_cuda: n={n} in {dtype} needs "
                         f"{tangent_smem_bytes(n, sizes, dtype)} B of shared memory")
    return tuple((B,) + s for s in out_shapes(n, sizes))


def dchain_tangent_smem_compiled(n: int, sizes, dtype: torch.dtype) -> int:
    """K3ᵗ's shared memory as the compiled source computes it (chip_smoke.py
    and the card tests hold ``tangent_smem_bytes`` to it)."""
    lib = library("dchain_tangent", _T_LAUNCHERS)
    fn = lib.dchain_tangent_smem
    if fn.restype is not ctypes.c_longlong:
        fn.argtypes = [_I, ctypes.POINTER(ctypes.c_int), _I, _I]
        fn.restype = ctypes.c_longlong
    sizes = tuple(int(s) for s in sizes)
    return fn(int(dtype == torch.float64), _c_sizes(sizes), len(sizes), n)


@cost.counted("dchain_tangent")
def dchain_tangent_hot(D, dD, outs, sizes):
    """The chain's tangent: K3ᵗ for CUDA tensors, the plain version for CPU
    tensors."""
    if D.device.type == "cpu":
        return dchain_tangent_plain(D, dD, outs, sizes)
    return dchain_tangent_cuda(D.contiguous(), dD.contiguous(),
                               [o.contiguous() for o in outs], sizes)


class Chain(torch.autograd.Function):
    """The chain's outputs by the hot dispatch (K3 or its plain version), with
    their forward-mode tangents (K3ᵗ on the card). Forward mode only, as
    ``jax.jacfwd``: backward raises."""

    @staticmethod
    def forward(D, sizes):
        return tuple(x if x._base is None else x.clone()
                     for x in _dchain_dispatch(D, sizes))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sizes = inputs[1]
        ctx.save_for_forward(inputs[0], *output)

    @staticmethod
    def jvp(ctx, dD, _):
        D, *outs = (primal(x) for x in ctx.saved_tensors)
        return dchain_tangent_hot(D, dD, outs, ctx.sizes)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the chain takes forward mode only")
