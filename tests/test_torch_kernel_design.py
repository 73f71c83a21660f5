"""The order of operations of the redesigned K1 and K3, on the CPU: their
plain mirrors (``gj_inverse_inplace``: the in-place Gauss-Jordan eight
pivots at a time; ``dchain_mirror``: the chain with reciprocal scalings and
in-place inverses) against the JAX package and the port's plain versions,
and the level sizes K3's wrapper takes. The kernels themselves are held
against these mirrors on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petlion_tpu.solver import linsolve as jax_linsolve

from petlion_tpu_torch import main_path
from petlion_tpu_torch.ops import dchain as kd
from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.solver import linsolve

torch.set_num_threads(1)

# one compile per shape: far quicker than dispatching the pivot loops op by op
jax_blocked_inverse = jax.jit(jax_linsolve.gj_inverse_blocked)


@pytest.mark.parametrize("n", [17, 31, 71])
def test_inplace_matches_jax_blocked_f64(n):
    """Same inverse as the JAX package's blocked Gauss-Jordan in float64,
    within 1e-12 of the output's scale, on equilibrated diagonally dominant
    matrices (n = 17 and 31 pad the last eight-pivot block)."""
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.standard_normal((4, n, n)) + 20.0 * np.eye(n))
    A = linsolve._equilibrate(A)[0]
    want = np.asarray(jax_blocked_inverse(jnp.asarray(A.numpy())))
    got = gk.gj_inverse_inplace(A).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_inplace_float32_on_newton_cores():
    """On the equilibrated 71×71 Schur cores of real Newton matrices
    (condition ~4e10), the float32 error against the float64 inverse, per
    matrix relative to its scale, is no worse than 4× that of the JAX
    package's blocked version in float32 (eight-wide blocks, as its TPU
    kernel), and better than the scalar in-place loop's."""
    D = main_path.newton_matrices()[0]
    As = linsolve._equilibrate(D)[0]
    ref = np.linalg.inv(As.numpy())
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)

    def err(X):
        return float((np.abs(np.asarray(X, np.float64) - ref) / scale).max())

    ours = err(gk.gj_inverse_inplace(As.float()).numpy())
    jax_blocked = err(jax_blocked_inverse(jnp.asarray(As.numpy(), jnp.float32)))
    scalar = err(gk.gj_inverse_inplace(As.float(), bs=1).numpy())
    assert ours <= 4 * jax_blocked
    assert ours < scalar


def test_dchain_mirror_matches_plain_f64():
    """The chain in the kernel's order of operations equals the plain chain
    in float64 within 1e-12 of each output's scale: at the default mesh's
    sizes (8×8 tile grid) and with levels above 32 (16×16 grid)."""
    rng = np.random.default_rng(11)
    for n, sizes in ((71, (20, 20)), (101, (35, 35))):
        D = (0.3 * rng.standard_normal((3, n, n))
             + 15.0 * np.eye(n) * rng.uniform(0.1, 10.0, (3, 1, n)))
        D = torch.as_tensor(D)
        got, want = kd.dchain_mirror(D, sizes), kd.dchain_plain(D, sizes)
        assert [tuple(o.shape) for o in got] == [tuple(o.shape) for o in want]
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_wrappers_take_every_size_the_earlier_kernels_took():
    """K1 takes n up to 169 in float32 and 120 in float64; K3 takes every
    set of level sizes whose shared memory fitted the earlier one-block
    layout (the core, [As | I] of the largest inverse, the AinvB panel),
    and refuses sizes that do not fit."""
    assert gk.MAX_N[torch.float32] >= 169 and gk.MAX_N[torch.float64] >= 120
    rng = np.random.default_rng(0)
    taken = 0
    for _ in range(3000):
        dtype = (torch.float32, torch.float64)[int(rng.integers(2))]
        n = int(rng.integers(2, 260))
        sizes, rest = [], n
        for _ in range(int(rng.integers(0, kd.MAX_LEVELS + 1))):
            if rest < 2:
                break
            nk = int(rng.integers(1, rest))
            sizes.append(nk)
            rest -= nk
        m_max = max(sizes + [rest])
        panel = max([1] + [nk * (n - sum(sizes[:i]) - nk)
                           for i, nk in enumerate(sizes)])
        earlier = (n * n + 2 * m_max * m_max + panel + 4 * m_max + 1) * dtype.itemsize
        if earlier <= gk.MAX_SMEM_BYTES:
            kd.check_sizes(n, tuple(sizes), dtype)
            taken += 1
    assert taken > 300
    with pytest.raises(ValueError):
        kd.check_sizes(150, (), torch.float32)
    with pytest.raises(ValueError):
        kd.check_sizes(71, (20, 51), torch.float32)
