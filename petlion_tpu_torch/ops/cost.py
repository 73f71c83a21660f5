"""Operation and byte counts: the hand-written kernels' closed forms, the
card's bounds, and the count of a stretch of eager work (``Counter``).

The kernels' formulas count the work the function needs, whatever the
kernel does to get it: each input read once, each output written once, and
the operations of the algorithm (a Gauss-Jordan inverse of an n×n matrix is
2n³). ``chip_smoke.py`` takes its bounds from here, and
``parallel.batch.batch_cost_analysis`` counts each launch by the same
formula, so a bound in PERF.md and a kernel's entry in a cost count are one
number.

``Counter`` is a ``TorchDispatchMode`` that counts every aten op dispatched
while it is active, the way XLA's cost analysis counts an HLO program:

* a matrix product by ``torch.utils.flop_counter``'s formula;
* an op that PyTorch tags pointwise or reduction, one operation per output
  element;
* any other op (copies, gathers, scatters, concatenations, factories) no
  operation;
* bytes: every tensor operand's and every result's elements times their
  size; a view (a result that aliases an operand without writing it) moves
  nothing and is not counted.

The kernels are ``ctypes`` launches, which the dispatcher does not see.
Their dispatch functions carry ``@counted(name)``: while a ``Counter`` is
active in the thread, each call adds one launch and the kernel's formula to
``kernels[name]`` and the totals, and the aten ops inside the call (the
plain version that stands in for the kernel on the CPU, the reshapes around
a launch) are not counted. So one stretch of work counts the same on the
CPU and on the card.
"""

from __future__ import annotations

import functools
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 outside the tensor
# cores (the kernels do scalar FMAs; TF32 would round), and FP64 on the
# tensor cores (IEEE double FMA, the card's fastest float64 rate: twice the
# 34 TFLOP/s outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_FP64_FLOP_PER_S = 67e12


def bound(n_bytes, flops, fp64=False):
    """(bound ms, bound_by) of work that moves n_bytes and does flops, at the
    card's float32 peak (or with `fp64` its float64 peak)."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / (PEAK_FP64_FLOP_PER_S if fp64 else PEAK_FP32_FLOP_PER_S) * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


# ---------------------------------------------------------------------------
# the kernels' closed forms: (operations, bytes) of one launch
# ---------------------------------------------------------------------------

def gj_inverse(B: int, n: int, itemsize: int):
    """K1: B inverses of n×n matrices (K2 the same over its M matrices)."""
    return 2 * n ** 3 * B, 2 * B * n * n * itemsize


gj_blocks = gj_inverse


def chain_shapes(n: int, sizes) -> list:
    """Per-cell shapes of the chain's outputs: per level of size nk on the
    current core of size m, invA (nk, nk), AinvB (nk, r) and C (r, nk) with
    r = m − nk; then the inverse of the rest."""
    shapes, rest = [], n
    for nk in sizes:
        r = rest - nk
        shapes += [(nk, nk), (nk, r), (r, nk)]
        rest = r
    shapes.append((rest, rest))
    return shapes


def dchain_flops(n: int, sizes) -> int:
    """Operations of the chain on one core: per level an n_k Gauss-Jordan
    inverse (2 n_k^3), AinvB (2 n_k^2 r) and the Schur update (2 r^2 n_k);
    then the inverse of the rest."""
    f, m = 0, n
    for nk in sizes:
        r = m - nk
        f += 2 * nk ** 3 + 2 * nk * nk * r + 2 * r * r * nk
        m = r
    return f + 2 * m ** 3


def dchain(B: int, n: int, sizes, itemsize: int):
    """K3: the chain on B cores of size n: reads the core, writes every
    output."""
    out = sum(a * b for a, b in chain_shapes(n, sizes))
    return dchain_flops(n, sizes) * B, (n * n + out) * itemsize * B


def gj_tangent(B: int, n: int, itemsize: int):
    """K1ᵗ: dX = −(X·dA)·X for B n×n pairs: two products, reads X and dA,
    writes dX."""
    return 4 * n ** 3 * B, 3 * B * n * n * itemsize


def dchain_tangent_flops(n: int, sizes) -> int:
    """Operations of the chain's tangent on one core: per level the two
    products of d invA (4 nk^3), d AinvB (4 nk^2 r), the tangent's Schur
    update (4 r^2 nk) and, before the last level, the primal's (2 r^2 nk);
    then the core inverse's tangent (4 m^3)."""
    f, m = 0, n
    for i, nk in enumerate(sizes):
        r = m - nk
        f += 4 * nk ** 3 + 4 * nk * nk * r + 4 * r * r * nk
        if i + 1 < len(sizes):
            f += 2 * r * r * nk
        m = r
    return f + 4 * m ** 3


def dchain_tangent(B: int, n: int, sizes, itemsize: int):
    """K3ᵗ on B cores: reads D, dD and of K3's outputs each level's invA and
    AinvB and the core inverse (each level's C it takes from D); writes a
    tangent an output."""
    shapes = chain_shapes(n, sizes)
    out = sum(a * b for a, b in shapes)
    out_read = out - sum(a * b for a, b in shapes[2:-1:3])
    return dchain_tangent_flops(n, sizes) * B, (2 * n * n + out_read + out) * itemsize * B


def _matrices(A):
    n = A.shape[-1]
    return A.numel() // max(n * n, 1), n, A.element_size()


# each dispatch function's arguments → its formula's
KERNELS = {
    "gj_inverse": lambda A: gj_inverse(*_matrices(A)),
    "gj_blocks": lambda A: gj_blocks(*_matrices(A)),
    "dchain": lambda D, sizes: dchain(D.shape[0], D.shape[-1], sizes, D.element_size()),
    "gj_tangent": lambda X, dA: gj_tangent(*_matrices(X)),
    "dchain_tangent": lambda D, dD, outs, sizes: dchain_tangent(
        D.shape[0], D.shape[-1], sizes, D.element_size()),
}


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()     # .counter: the thread's active Counter


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


class Counter(TorchDispatchMode):
    """Counts the aten ops dispatched in this thread while it is active
    (see the module docstring) and the kernels' launches by their formulas.
    ``result()`` gives the totals under XLA's key names."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernels = {}
        self._paused = 0

    def __enter__(self):
        if getattr(_ACTIVE, "counter", None) is not None:
            raise RuntimeError("a cost Counter is already active in this thread")
        _ACTIVE.counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.counter = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or _is_view(func):
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags or torch.Tag.reduction in func.tags:
            flops = sum(x.numel() for x in tree_flatten(out)[0]
                        if isinstance(x, torch.Tensor))
        else:
            flops = 0
        self.ops += 1
        self.flops += int(flops)
        self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out

    def launch(self, name: str, flops: int, n_bytes: int):
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
        k["launches"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(n_bytes)
        self.flops += int(flops)
        self.bytes += int(n_bytes)

    def result(self) -> dict:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes),
                "ops": self.ops, "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def counted(name: str):
    """Decorator of a kernel's dispatch function: under an active Counter a
    call is one launch of `name`, counted by ``KERNELS[name]``, and the aten
    ops inside it are not counted."""
    formula = KERNELS[name]

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args):
            c = getattr(_ACTIVE, "counter", None)
            if c is None or c._paused:
                return fn(*args)
            c.launch(name, *formula(*args))
            c._paused += 1
            try:
                return fn(*args)
            finally:
                c._paused -= 1
        return run
    return wrap
