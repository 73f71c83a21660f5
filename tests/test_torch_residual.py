"""The PyTorch port's batched residual against the JAX `residual_core` and
`control.full_residual`, in float64, on randomized off-equilibrium states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
from petlion_tpu.physics import kinetics as jk
from petlion_tpu.physics.initial_guess import initial_guess as jax_initial_guess
from petlion_tpu.physics.residuals import residual_core as jax_residual_core
from petlion_tpu.solver import control as jax_control

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops.jacobian import stacked_jvp
from petlion_tpu_torch.physics import kinetics as tk
from petlion_tpu_torch.physics.initial_guess import initial_guess
from petlion_tpu_torch.solver import control
from test_residual_oracle import sample_state

torch.set_num_threads(1)

SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def models():
    p = pt.petlion(pt.LCO)
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    return p, q


def _theta_batch(q, B):
    return {k: v.reshape(1, 1).expand(B, 1) for k, v in q.theta.items()}


def test_residual_matches_jax(models):
    """Three off-equilibrium states in one batch: every row equals the JAX
    residual of that cell at rtol 1e-12 (atol 1e-12 of the row's scale,
    for rows that cancel to ~0)."""
    p, q = models
    cfg = p.cfg
    ys = np.stack([sample_state(p.theta, cfg, seed=s) for s in SEEDS])
    rng = np.random.default_rng(11)
    yps = 1e-3 * rng.standard_normal(ys.shape) * np.abs(ys)
    thj = {k: jnp.asarray(v, jnp.float64) for k, v in p.theta.items()}
    th = _theta_batch(q, len(SEEDS))
    yt, ypt = torch.as_tensor(ys), torch.as_tensor(yps)
    value = torch.tensor([-1.0, 0.5, 2.0], dtype=torch.float64)

    r_t = ptt.residual_core(0.0, yt, ypt, th, q.cfg).numpy()
    spec_t = control.ControlSpec("I")
    f_t = control.full_residual(spec_t, value, 0.0, yt, ypt, th, q.cfg).numpy()
    spec_j = jax_control.ControlSpec("I")

    @jax.jit
    def jax_side(y, yp, v):
        # one trace of the reference residual serves all three cells
        return (jax_residual_core(0.0, y, yp, thj, cfg),
                jax_control.full_residual(spec_j, v, 0.0, y, yp, thj, cfg))

    for b in range(len(SEEDS)):
        r_j, f_j = (np.asarray(a) for a in jax_side(
            jnp.asarray(ys[b]), jnp.asarray(yps[b]), float(value[b])))
        for got, ref in ((r_t[b], r_j), (f_t[b], f_j)):
            np.testing.assert_allclose(got, ref, rtol=1e-12,
                                       atol=1e-12 * np.abs(ref).max())


def test_initial_guess_matches_jax(models):
    p, q = models
    socs = np.array([1.0, 0.37, 0.0])
    thj = {k: jnp.asarray(v, jnp.float64) for k, v in p.theta.items()}
    got = initial_guess(torch.as_tensor(socs), _theta_batch(q, 3), q.cfg).numpy()
    for b, soc in enumerate(socs):
        ref = np.asarray(jax_initial_guess(soc, thj, p.cfg, jnp.float64))
        np.testing.assert_allclose(got[b], ref, rtol=1e-14, atol=0)


def test_clamp_derivatives_at_ties_match_jax():
    """The kinetics/OCV clamps differentiate like jnp.maximum / jnp.clip:
    1/2 at a tie, and sqrt's infinite slope at 0 — through the port's own
    Jacobian-vector product."""
    cases = [(lambda v: jnp.clip(v, -30.0, 30.0), lambda v: tk._clip(v, -30.0, 30.0),
              (30.0, -30.0, 29.0)),
             (lambda v: jk._sqrt_relu(v, 1e-4), lambda v: tk._sqrt_relu(v, 1e-4),
              (1e-4, 4.0)),
             (lambda v: jk._sqrt_relu(v), lambda v: tk._sqrt_relu(v), (0.0,))]
    for f_jax, f_torch, xs in cases:
        x = torch.tensor(xs, dtype=torch.float64)[:, None]
        got = stacked_jvp(lambda v, d: f_torch(v), x, {},
                          torch.ones(1, 1, dtype=torch.float64))[:, 0, 0]
        want = [float(jax.grad(f_jax)(v)) for v in xs]
        np.testing.assert_array_equal(got.numpy(), np.array(want))
