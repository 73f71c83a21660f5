"""The port's Gauss-Jordan inverses: the plain versions against the JAX
package's (float64), the float32 plain version against the Pallas kernel in
interpret mode, and the CPU dispatch (the kernel itself on the card:
tests/test_torch_cuda.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petlion_tpu.ops import pallas_gj
from petlion_tpu.solver import linsolve as jax_linsolve

from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.solver import linsolve

torch.set_num_threads(1)


def _mats(B, n, seed, scale=20.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, n)) + scale * np.eye(n)


def test_plain_inverses_match_jax_f64():
    for B, n in ((4, 10), (3, 30), (2, 71)):
        A = _mats(B, n, seed=n)
        bs = gk._best_bs(n)
        assert bs == jax_linsolve._best_bs(n)
        refs = jax.jit(lambda a: (
            jax_linsolve.gj_inverse(a),
            jax_linsolve.gj_inverse_blocked(a, bs=bs),
            *jax_linsolve.equilibrated_inv_factor(a)))(jnp.asarray(A))
        At = torch.as_tensor(A)
        ours = (gk.gj_inverse(At), gk.gj_inverse_blocked(At, bs=bs),
                *linsolve.equilibrated_inv_factor(At))
        for got, want in zip(ours, refs):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)


def test_f32_plain_matches_pallas_interpret():
    """float32 plain blocked GJ (what a CPU tensor takes) against the TPU
    kernel run in interpret mode, as tests/test_pallas_gj.py runs it:
    2e-4 to the float64 inverse, 1e-4 to each other."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    rng = np.random.default_rng(0)
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        for B, n in ((8, 37), (5, 71)):
            A = (rng.standard_normal((B, n, n)) + 20 * np.eye(n)).astype(np.float32)
            pallas = np.asarray(pallas_gj.gj_inverse_pallas(jnp.asarray(A)))
            ours = gk.gj_inverse_hot(torch.as_tensor(A)).numpy()
            ref = np.linalg.inv(A.astype(np.float64))
            np.testing.assert_allclose(ours, ref, atol=2e-4)
            np.testing.assert_allclose(ours, pallas, atol=1e-4)
            resid = np.abs(A.astype(np.float64) @ ours.astype(np.float64)
                           - np.eye(n)).max()
            assert resid < 1e-3
    finally:
        pl.pallas_call = orig


def test_cpu_dispatch_never_launches_kernel():
    gk.reset_launch_counts()
    for n in (10, 30, 71):
        A = torch.as_tensor(_mats(3, n, seed=5 + n))
        inv, row, col = linsolve.equilibrated_inv_factor(A)
        x = linsolve.equilibrated_inv_solve((inv, row, col), A[:, :, 0])
        np.testing.assert_allclose(x.numpy(), np.eye(n)[None, :, 0].repeat(3, 0),
                                   atol=1e-12)
    assert gk.LAUNCHES["gj_inverse"] == 0
    with pytest.raises(ValueError):
        gk.gj_inverse_cuda(torch.zeros(2, 71, 71))

