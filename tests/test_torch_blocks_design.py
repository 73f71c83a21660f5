"""The order of operations of the redesigned K2 (csrc/gj_blocks.cu), on the
CPU: its plain mirror ``gj_blocks_mirror`` (the in-place Gauss-Jordan one
pivot at a time, each pivot row's scaling deferred to the end, the matrix
padded with an identity tail to the kernel's width) against the JAX
package's scalar Gauss-Jordan and the port's plain version, and the
wrapper's dispatch. The kernel itself is held against this mirror on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petlion_tpu.solver import linsolve as jax_linsolve

from petlion_tpu_torch import main_path
from petlion_tpu_torch.ops import gj_blocks as kb
from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.solver import linsolve

torch.set_num_threads(1)

# one compile per shape: far quicker than dispatching the pivot loop op by op
jax_gj_inverse = jax.jit(jax_linsolve.gj_inverse)


def _stack(M, n, seed, dtype=torch.float64):
    """M equilibrated diagonally dominant n×n matrices."""
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((M, n, n)) + 15.0 * np.eye(n), dtype=dtype)
    return linsolve._equilibrate(A)[0]


@pytest.mark.parametrize("n", [10, 30])
def test_mirror_matches_jax_gj_inverse_f64(n):
    """The mirror gives the JAX package's scalar Gauss-Jordan inverse in
    float64, within 1e-12 of the output's scale, at the main path's sizes."""
    A = _stack(6, n, seed=n)
    want = np.asarray(jax_gj_inverse(jnp.asarray(A.numpy())))
    got = kb.gj_blocks_mirror(A).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_mirror_float32_on_newton_blocks():
    """On the equilibrated particle and c_e blocks of real Newton matrices,
    the mirror's float32 error against the float64 inverse, per matrix
    relative to its scale, is at most 2× that of the plain version."""
    for G in main_path.newton_matrices()[3]:
        n = G.shape[-1]
        A = G.reshape(-1, n, n)
        ref = np.linalg.inv(A.numpy())
        scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)

        def err(X):
            return float((np.abs(X.numpy().astype(np.float64) - ref) / scale).max())

        assert err(kb.gj_blocks_mirror(A.float())) <= 2 * err(kb.gj_blocks_plain(A.float()))


def test_identity_tail_is_exact():
    """Padding to the kernel's width changes nothing: the padded mirror
    equals the unpadded one within 1e-12 at every n the kernel pads
    (n = 17 runs at 32), and equals the plain version."""
    for n in range(1, kb.MAX_N + 1):
        w = kb.kernel_width(n)
        assert w >= n and w in (n, 8, 16, 32)
        A = _stack(3, n, seed=100 + n)
        padded, unpadded = kb.gj_blocks_mirror(A), kb.gj_blocks_mirror(A, width=n)
        scale = float(unpadded.abs().max())
        assert float((padded - unpadded).abs().max()) <= 1e-12 * scale
        assert float((padded - kb.gj_blocks_plain(A)).abs().max()) <= 1e-12 * scale
    assert kb.kernel_width(17) == 32


def test_cpu_tensor_takes_the_plain_version():
    """A CPU tensor never launches K2, at every n it takes, and gets the
    plain version; gj_blocks_cuda refuses a CPU tensor and n = 33."""
    gk.reset_launch_counts()
    for n in range(1, kb.MAX_N + 1):
        A = _stack(2, n, seed=n).float().reshape(1, 2, n, n)
        got = kb.gj_blocks_hot(A)
        assert got.shape == A.shape
        assert torch.equal(got, kb.gj_blocks_plain(A))
    assert gk.LAUNCHES["gj_blocks"] == 0
    with pytest.raises(ValueError):
        kb.gj_blocks_cuda(torch.zeros(2, 10, 10))
    with pytest.raises(ValueError):
        kb.gj_blocks_cuda(torch.zeros(2, kb.MAX_N + 1, kb.MAX_N + 1))
