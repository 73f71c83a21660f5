"""The designs of the tangent kernels K1ᵗ (csrc/gj_tangent.cu) and K3ᵗ
(csrc/dchain_tangent.cu), on the CPU: their plain mirrors
(`gj_kernel.gj_tangent_mirror`: the panel split and the depth summed eight
at a time; `dchain.dchain_tangent_mirror`: the fused level pass with its
in-place trailing cores) against the plain versions and against `jax.jvp`
of the JAX package's inverse and chain; the launch plans at every shape the
estimation path, chip_smoke.py and the card tests launch; and the cost
formulas the bounds read. No simulation runs here. The kernels themselves
are held against the plain versions on the card
(tests/test_torch_cuda_estimation.py, chip_smoke.py)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petlion_tpu.ops import structured as jax_structured
from petlion_tpu.solver import linsolve as jax_linsolve

from petlion_tpu_torch.ops import cost
from petlion_tpu_torch.ops import dchain as kd
from petlion_tpu_torch.ops import gj_kernel as gk

torch.set_num_threads(1)


def _inverse_pair(B, n, seed):
    """An inverse X of an equilibrated diagonally dominant matrix and a
    tangent dA, float64."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + 20.0 * np.eye(n)
    A /= np.abs(A).max(axis=-1, keepdims=True)
    return torch.as_tensor(np.linalg.inv(A)), torch.as_tensor(rng.standard_normal((B, n, n)))


def _core(B, n, seed):
    rng = np.random.default_rng(seed)
    D = torch.as_tensor(rng.standard_normal((B, n, n)) + 8.0 * np.eye(n))
    return D, torch.as_tensor(rng.standard_normal((B, n, n)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (B, n): a panel split over one or two matrices (path 14(a)), the particle
# and c_e blocks (path 14(b)), a matrix a block, and the two-step staging
@pytest.mark.parametrize("B, n", [(1, 71), (2, 71), (20, 10), (2, 30), (27, 71), (67, 17),
                                  (3, 128), (17, 128)])
def test_gj_tangent_mirror_matches_plain(B, n):
    """K1ᵗ's order of operations gives −(X·dA)·X within 1e-12 of its scale
    in float64, in either regime."""
    X, dA = _inverse_pair(B, n, seed=B * 1000 + n)
    assert _rel(gk.gj_tangent_mirror(X, dA), gk.gj_tangent_plain(X, dA)) <= 1e-12


@jax.jit
def _jax_inverse_jvp(A, dA):
    return jax.jvp(jax_linsolve.gj_inverse_blocked, (A,), (dA,))[1]


def test_gj_tangent_mirror_matches_jax_jvp():
    """At n = 30 (path 14(b)'s c_e block), the mirror on the inverse equals
    `jax.jvp` of the JAX package's `linsolve.gj_inverse_blocked` within
    1e-10 of the tangent's scale."""
    rng = np.random.default_rng(30)
    A = rng.standard_normal((2, 30, 30)) + 20.0 * np.eye(30)
    A /= np.abs(A).max(axis=-1, keepdims=True)
    dA = rng.standard_normal((2, 30, 30))
    got = gk.gj_tangent_mirror(torch.as_tensor(np.linalg.inv(A)), torch.as_tensor(dA))
    assert _rel(got, _jax_inverse_jvp(jnp.asarray(A), jnp.asarray(dA))) <= 1e-10


@pytest.mark.parametrize("B, n, sizes", [(2, 71, (20, 20)), (1, 40, (7, 9, 5, 3)),
                                         (1, 19, (6,)), (2, 25, ())])
def test_dchain_tangent_mirror_matches_plain(B, n, sizes):
    """K3ᵗ's fused level pass, its cores updated in place, gives every output
    of the plain tangent within 1e-12 of the output's scale in float64, at
    path 14(b)'s levels and at one to four levels or none."""
    D, dD = _core(B, n, seed=n)
    outs = kd.dchain_plain(D, sizes)
    for got, want in zip(kd.dchain_tangent_mirror(D, dD, outs, sizes),
                         kd.dchain_tangent_plain(D, dD, outs, sizes)):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-12


def _jax_chain(D, sizes):
    """The JAX package's CPU chain (structured.py:462-470 over
    `_equilibrated_inv`, then the core's folded equilibrated inverse)."""
    outs = []
    for nk in sizes:
        A, B, C = D[..., :nk, :nk], D[..., :nk, nk:], D[..., nk:, :nk]
        invA = jax_structured._equilibrated_inv(A)
        AinvB = jnp.matmul(invA, B, precision="highest")
        D = D[..., nk:, nk:] - jnp.matmul(C, AinvB, precision="highest")
        outs += [invA, AinvB, C]
    outs.append(jax_structured._equilibrated_inv(D))
    return tuple(outs)


@functools.partial(jax.jit, static_argnums=2)
def _jax_chain_jvp(D, dD, sizes):
    return jax.jvp(lambda x: _jax_chain(x, sizes), (D,), (dD,))[1]


def test_dchain_tangent_mirror_matches_jax_jvp():
    """On a 24-state core with levels (8, 6), every output's tangent from the
    mirror (on the port's chain) equals `jax.jvp` of the JAX package's CPU
    chain within 1e-10 of its scale."""
    sizes = (8, 6)
    D, dD = _core(1, 24, seed=24)
    got = kd.dchain_tangent_mirror(D, dD, kd.dchain_plain(D, sizes), sizes)
    want = _jax_chain_jvp(jnp.asarray(D.numpy()), jnp.asarray(dD.numpy()), sizes)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-10


def _instances():
    """{dtype: {(np, pr, mb)}}: the kernel instances csrc/gj_tangent.cu
    compiles (its GJT_F64 / GJT_F32 lists)."""
    src = (gk.CSRC / "gj_tangent.cu").read_text()
    out = {}
    for dtype, tag in ((torch.float64, "GJT_F64"), (torch.float32, "GJT_F32")):
        body = re.search(rf"#define {tag}\(X\)(.*?)\n\n", src, re.S).group(1)
        out[dtype] = {tuple(int(v) for v in m)
                      for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}
    return out


F64, F32 = torch.float64, torch.float32
# every (B, n, dtype) K1ᵗ launches at: path 14 (a) and (c) (one or two
# fitted parameters at n = 71), (b) (10 or 20 particle blocks, one or two c_e
# blocks), chip_smoke.py's timed shapes, and the card tests' (the regime
# threshold on both sides at n = 17, 71, 128 and 169)
K1T_SHAPES = [(1, 71, F64), (2, 71, F64), (10, 10, F64), (20, 10, F64), (1, 30, F64),
              (2, 30, F64), (1024, 71, F32), (1024, 71, F64), (10240, 10, F32),
              (10240, 10, F64), (1024, 30, F32), (1024, 30, F64), (3, 17, F32), (3, 17, F64),
              (5, 101, F32), (5, 101, F64), (2, 128, F64), (3, 169, F32), (66, 17, F64),
              (67, 17, F64), (26, 71, F64), (27, 71, F64), (16, 128, F64), (17, 128, F64),
              (12, 169, F32), (13, 169, F32)]


@pytest.mark.parametrize("B, n, dtype", K1T_SHAPES)
def test_gj_tangent_plan(B, n, dtype):
    """K1ᵗ's launch plan: an instance the source compiles, shared memory and
    threads a block within Hopper's limits, the panels covering the matrix,
    and the regime set by B·⌈n/16⌉ against the SM count."""
    plan = gk.gj_tangent_plan(B, n, dtype)
    assert (plan.np, plan.panel, plan.mb) in _instances()[dtype]
    assert n <= plan.np and plan.np % 8 == 0 and plan.panel % 8 == 0
    assert plan.smem <= gk.MAX_SMEM_BYTES and plan.smem <= 232448
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.panels * plan.panel >= n and (plan.panels - 1) * plan.panel < n
    assert plan.blocks == -(-B // plan.mb) * plan.panels
    small = B * -(-n // 16) <= gk.SM_COUNT
    assert plan.regime == ("small" if small else "large")
    if small:
        assert plan.panel == min(16, plan.np) and plan.mb == 1
        assert plan.blocks <= gk.SM_COUNT
    assert plan.rows == (-(-plan.panel // 16) * 16 if dtype == F64 else plan.panel)
    assert plan.smem == (plan.rows + max(plan.np, plan.rows) + (plan.np if plan.three else 0)) \
        * (plan.np + 4) * plan.mb * dtype.itemsize


@pytest.mark.parametrize("n, dtype", [(17, F64), (71, F64), (128, F64), (169, F32),
                                      (10, F64), (30, F64)])
def test_gj_tangent_regime_switch(n, dtype):
    """The regime flips from a block a panel to a block a matrix (or two
    panels of half the rows at n = 128 in float64 and 169 in float32) between
    the largest B whose panels fit one wave of 132 SMs and the next."""
    b_max = gk.SM_COUNT // -(-n // 16)
    below, above = gk.gj_tangent_plan(b_max, n, dtype), gk.gj_tangent_plan(b_max + 1, n, dtype)
    assert below.regime == "small" and above.regime == "large"
    assert below.panel == min(16, below.np) and above.panel >= below.panel
    assert above.blocks < below.blocks or n <= 16


# (n, sizes, dtype): the LCO core of path 14(b) and chip_smoke.py, and the
# other models' cores the chain takes (the 121-state thermal core in float32
# only: its two float64 cores alone take 240 KB)
K3T_CORES = [(71, (20, 20), F64), (71, (20, 20), F32), (92, (20, 20), F64),
             (92, (20, 20), F32), (121, (20, 20), F32), (40, (7, 9, 5, 3), F64),
             (25, (), F32)]


@pytest.mark.parametrize("n, sizes, dtype", K3T_CORES)
def test_dchain_tangent_plan(n, sizes, dtype):
    """K3ᵗ's shared memory fits a block; at path 14(b)'s core two float64
    blocks (111,904 B each) and four float32 blocks (55,952 B) fit an SM."""
    smem = kd.tangent_smem_bytes(n, sizes, dtype)
    assert smem <= gk.MAX_SMEM_BYTES
    blocks = kd.tangent_blocks_per_sm(n, sizes, dtype)
    assert blocks >= 1
    if n == 71:
        assert smem == {F64: 111904, F32: 55952}[dtype]
        assert blocks == {F64: 2, F32: 4}[dtype]
    assert kd.tangent_smem_bytes(121, (20, 20), F64) > gk.MAX_SMEM_BYTES


def test_tangent_cost_formulas():
    """The bounds' work (PERF.md): K1ᵗ at (1024, 71) 1.46 GFLOP; K3ᵗ at
    (1024, 71), levels (20, 20), 151.7 MB in float64 and 75.9 MB in float32
    (D, dD, each level's invA and AinvB and X read, a tangent an output
    written)."""
    flops, _ = cost.gj_tangent(1024, 71, 4)
    assert flops == 4 * 71 ** 3 * 1024 and 1.46e9 <= flops < 1.47e9
    for size, mb in ((8, 151.7), (4, 75.9)):
        _, n_bytes = cost.dchain_tangent(1024, 71, (20, 20), size)
        assert round(n_bytes / 1e6, 1) == mb
