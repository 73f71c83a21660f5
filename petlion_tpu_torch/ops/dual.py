"""Forward-mode tangents through the solver (``torch.autograd.forward_ad``).

Parameter estimation (``estimation.py``) differentiates a whole run in
forward mode, as the JAX package's ``jax.jacfwd`` does: the parameters enter
as dual tensors and their tangents ride along through consistent
initialization, the BDF steps, Newton and the recorded trace. Three things
would drop a tangent silently, and this module holds what the solver does
about each:

* ``.detach()`` — the Jacobians' reverse passes take leaves of their
  inputs. ``grad_leaf`` makes a leaf that keeps the outer tangent (a clone;
  reverse mode through it then carries the tangent, ``create_graph`` or
  not), and ``detach`` drops the reverse graph but keeps the tangent.
* the kernels' ``ctypes`` launches write into fresh outputs, which carry
  no tangent. Each kernel's dispatch sends a dual input through an
  ``autograd.Function`` whose ``jvp`` is the tangent kernel, and every
  ``ctypes`` wrapper refuses a dual input (``refuse``).
* ``torch.inference_mode`` drops tangents; ``torch.no_grad`` keeps them.

A dual run is slow on the host where an op meets an operand without a
tangent; ``fast_zero_tangents`` and dual seeds for the reverse passes
(``grad_seed``) take most of that cost away.

Without a dual input every helper takes the path it took before: the same
ops, no extra launch.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.autograd.forward_ad as fwAD


def tangent(x):
    """The forward-mode tangent of `x` at the current dual level, or None."""
    return fwAD.unpack_dual(x).tangent


def has_tangent(x) -> bool:
    return torch.is_tensor(x) and tangent(x) is not None


def refuse(name: str, *xs):
    """Raise if any of `xs` carries a forward-mode tangent: a kernel launched
    through ctypes would drop it."""
    if fwAD._current_level < 0:     # no dual level is open: nothing carries one
        return
    if any(has_tangent(x) for x in xs):
        raise ValueError(f"{name}: the input carries a forward-mode tangent, "
                         "which the kernel would drop; dispatch through the "
                         "kernel's autograd.Function")


def grad_leaf(x):
    """A leaf of `x` that reverse mode differentiates: a clone when `x` carries
    a tangent (it keeps it), else ``x.detach()``."""
    if has_tangent(x):
        return x.clone().requires_grad_(True)
    return x.detach().requires_grad_(True)


def grad_seed(like, fill: float = 1.0):
    """The seed of a reverse pass over outputs shaped as `like`, when `like`
    carries a tangent: `fill` everywhere, dual with a zero tangent, so that
    the pass's ops meet dual operands only (an operand without a tangent
    costs a zero-tangent detour an op). None otherwise: the pass's default
    seed of ones."""
    if not has_tangent(like):
        return None
    seed = torch.full_like(primal(like), fill)
    return fwAD.make_dual(seed, torch.zeros_like(seed))


def dual_constant(x, like):
    """`x` with a zero tangent when `like` carries a tangent, else `x`."""
    if not has_tangent(like):
        return x
    return fwAD.make_dual(x, torch.zeros_like(x))


def detach(x):
    """``x.detach()`` that keeps a forward-mode tangent."""
    t = tangent(x)
    if t is None:
        return x.detach()
    return fwAD.make_dual(x.detach(), t.detach())


def primal(x):
    """`x` without its forward-mode tangent (a view)."""
    return fwAD.unpack_dual(x).primal


def _shape(x):
    return tuple(x.shape) if torch.is_tensor(x) else ()


def _zero_tangent_meta(a, b, *, alpha=1):
    """Meta kernel of add.Tensor and mul.Tensor: the broadcast shape and the
    promoted dtype, which is all that the zero-tangent kernels read of it
    (their results are fresh zero tensors or copies of the other operand)."""
    shape = torch.broadcast_shapes(_shape(a), _shape(b))
    return torch.empty(shape, dtype=torch.result_type(a, b), device="meta")


_fast_meta_on = False


@contextlib.contextmanager
def fast_zero_tangents():
    """Inside: a lighter meta kernel for aten add.Tensor and mul.Tensor.

    In a forward-mode op whose other operand has no tangent (a constant, a
    Python number), PyTorch's formulas stand a zero tensor in for the missing
    tangent, and the zero tensor's add and mul take their output shape from
    the ops' meta kernels, which PyTorch 2.13 runs as its Python reference
    implementations: ~0.4 ms of host time a call, some 2,000 calls a trip of
    the LCO run. Inside this context the meta kernels of those two ops are
    a broadcast of the shapes and a type promotion (the values are the same
    bit for bit); on exit PyTorch's own come back.

    The kernels are the process's, for every thread: inside, a meta add or
    mul returns a contiguous result whatever its operands' strides. So the
    context does not nest, and entering it while it is on raises
    RuntimeError."""
    global _fast_meta_on
    if _fast_meta_on:
        raise RuntimeError("fast_zero_tangents is already on: it replaces the "
                           "process's meta kernels of add and mul and does not nest")
    with warnings.catch_warnings():
        # registering over PyTorch's Python meta kernels warns that it overrides
        warnings.simplefilter("ignore")
        lib = torch.library.Library("aten", "IMPL")
        for op in ("add.Tensor", "mul.Tensor"):
            lib.impl(op, _zero_tangent_meta, "Meta", allow_override=True)
    _fast_meta_on = True
    try:
        yield
    finally:
        lib._destroy()
        _fast_meta_on = False
