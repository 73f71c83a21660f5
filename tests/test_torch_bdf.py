"""The port's batch-first BDF pieces against the JAX package per cell, with
cells at different orders, and its consistent initialization."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import petlion_tpu as pt
from petlion_tpu.physics.initial_guess import initial_guess as jax_initial_guess
from petlion_tpu.solver import bdf as jbdf
from petlion_tpu.solver import control as jax_control
from petlion_tpu.solver.newton import consistent_init as jax_consistent_init

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops.plan import get_plan
from petlion_tpu_torch.physics.initial_guess import initial_guess
from petlion_tpu_torch.solver import bdf, control
from petlion_tpu_torch.solver.newton import consistent_init

torch.set_num_threads(1)


def test_predict_change_D_dense_eval_match_jax():
    rng = np.random.default_rng(4)
    B, N = 3, 6
    order = np.array([1, 3, 5])
    D = rng.standard_normal((B, 8, N)) * 10.0 ** -np.arange(8)[None, :, None]
    h = np.array([0.5, 2.0, 7.0])
    t = np.array([10.0, 100.0, 995.0])
    yp = rng.standard_normal((B, N))
    factor = np.array([0.3, 1.7, 4.0])
    t_bound = 1000.0        # clips the third cell's step

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64))

    st = bdf.BDFState(t=torch.as_tensor(t), h=torch.as_tensor(h), order=i64(order),
                      D=torch.as_tensor(D), n_equal=i64([0, 1, 2]),
                      status=i64([0, 0, 0]), yp=torch.as_tensor(yp),
                      n_steps=i64([1, 2, 3]), n_rejected=i64([0, 0, 0]),
                      n_fails=i64([0, 0, 0]))
    pred = bdf.predict(st, t_bound, 1e-10, np.inf)
    cD = bdf.change_D(torch.as_tensor(D), i64(order), torch.as_tensor(factor))
    t_eval = t - 0.37 * h
    dy, dyp = bdf.dense_eval(torch.as_tensor(D), torch.as_tensor(h), i64(order),
                             torch.as_tensor(t), torch.as_tensor(t_eval))
    # one trace of each reference function serves all three cells
    j_predict = jax.jit(jbdf.predict)
    j_change_D = jax.jit(jbdf.change_D)
    j_dense_eval = jax.jit(jbdf.dense_eval)
    for b in range(B):
        sj = jbdf.BDFState(
            t=jnp.asarray(t[b]), h=jnp.asarray(h[b]), order=jnp.int32(order[b]),
            D=jnp.asarray(D[b]), n_equal=jnp.int32(b), status=jnp.int32(0),
            yp=jnp.asarray(yp[b]), n_steps=jnp.int32(b + 1),
            n_rejected=jnp.int32(0), n_fails=jnp.int32(0))
        ref = j_predict(sj, t_bound, 1e-10, np.inf)
        for got, want in zip(pred, ref):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(
            cD[b].numpy(),
            np.asarray(j_change_D(jnp.asarray(D[b]), order[b], factor[b])),
            rtol=1e-12, atol=1e-14)
        ry, ryp = j_dense_eval(jnp.asarray(D[b]), h[b], order[b], t[b],
                               t_eval[b])
        np.testing.assert_allclose(dy[b].numpy(), np.asarray(ry), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(dyp[b].numpy(), np.asarray(ryp), rtol=1e-12,
                                   atol=1e-14)


def test_consistent_init_matches_jax():
    """SOC 1, I = -1C, two cells (one perturbed): y, yp after consistent
    initialization equal the JAX package's at 1e-9."""
    p = pt.petlion(pt.LCO)
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    plan = get_plan(q.cfg, q.theta_floats())
    L, nd = p.cfg.layout, p.cfg.layout.N_diff
    overrides = [{}, {"D_sp": 1.3e-14, "k_n": 4.0e-11}]
    value = -1.0

    th = {k: v.reshape(1, 1).repeat(2, 1) for k, v in q.theta.items()}
    for b, o in enumerate(overrides):
        for k, v in o.items():
            th[k][b] = v
    spec = control.ControlSpec("I")
    data = dict(th, _v=torch.full((2, 1), value, dtype=torch.float64))

    def F(t, y, yp, d):
        return control.full_residual(spec, d["_v"][:, 0], t, y, yp, d, q.cfg)

    y0 = initial_guess(torch.ones(2, dtype=torch.float64), th, q.cfg)
    y0[:, L.sl("I").start] = value
    with torch.no_grad():
        got = consistent_init(F, y0, nd, data, reltol_init=1e-3, maxiter=100,
                              c_e0=1000.0, jac_plan=plan)
    assert bool(got.converged.all())

    spec_j = jax_control.ControlSpec("I")

    @jax.jit
    def jax_init(thj):
        def Fj(t, y, yp):
            return jax_control.full_residual(spec_j, value, t, y, yp, thj, p.cfg)
        y0j = jax_initial_guess(1.0, thj, p.cfg, jnp.float64)
        y0j = y0j.at[L.sl("I").start].set(value)
        # the JAX side takes its dense jacfwd algebraic block (the same
        # matrix as the port's colored one, and far quicker to compile)
        return jax_consistent_init(Fj, y0j, nd, reltol_init=1e-3, maxiter=100,
                                   c_e0=1000.0)

    for b, o in enumerate(overrides):
        thj = {k: jnp.asarray(float(v), jnp.float64)
               for k, v in dict(p.theta, **o).items()}
        ref = jax_init(thj)
        assert bool(ref.converged)
        assert int(got.iterations[b]) == int(ref.iterations)
        for a, r in ((got.y[b], ref.y), (got.yp[b], ref.yp)):
            r = np.asarray(r)
            np.testing.assert_allclose(a.numpy(), r, rtol=1e-9,
                                       atol=1e-9 * np.abs(r).max())
