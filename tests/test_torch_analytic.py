"""The port's analytic Newton-matrix assembly (ops/analytic.py) against the
JAX package's AnalyticJacobian and against the port's own colored sweeps,
in float64, as tests/test_analytic.py pins the JAX package's."""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
from petlion_tpu.ops import analytic as jax_an
from petlion_tpu.ops import jacobian as jax_jac
from petlion_tpu.solver import control as jax_control

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops import analytic
from petlion_tpu_torch.ops import plan as planmod
from petlion_tpu_torch.ops.plan import Route, get_plan
from petlion_tpu_torch.physics.initial_guess import initial_guess
from petlion_tpu_torch.solver import control, linsolve
from petlion_tpu_torch.solver.newton import consistent_init

torch.set_num_threads(1)

B = 2


def _setup(theta_extra):
    """Port plan (analytic) and model, two cells' states, c0 and BDF
    constants from a numpy seed."""
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    theta = dict(q.theta_floats(), **theta_extra)
    plan = get_plan(q.cfg, theta, Route())
    assert plan.analytic is not None
    L = q.cfg.layout
    rng = np.random.default_rng(len(theta_extra) + 5)
    th = {k: torch.full((B, 1), v, dtype=torch.float64) for k, v in theta.items()}
    y = initial_guess(torch.tensor([0.52, 0.3], dtype=torch.float64), th,
                      q.cfg).numpy()
    y *= 1.0 + 0.04 * rng.standard_normal(y.shape)
    y[:, L.sl("Phi_e")] = 0.02 * rng.standard_normal((B, 30))
    y[:, L.sl("j")] = 2e-6 * rng.standard_normal((B, 20))
    y[:, L.sl("I").start] = [0.9, -1.0]
    c0 = rng.uniform(0.2, 40.0, B)
    const = 1e-3 * rng.standard_normal(y.shape) - c0[:, None] * y
    return q, theta, plan, th, y, c0, const


@pytest.fixture(scope="module")
def jax_analytic():
    """The JAX package's AnalyticJacobian on the port's pattern (same
    coloring), built once; keyed by the θ it was built from."""
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    plan = get_plan(q.cfg, q.theta_floats(), Route())
    cfg_j = pt.petlion(pt.LCO).cfg
    colored_j = jax_jac.ColoredJacobian(plan.colored.pattern)
    return cfg_j, colored_j, jax_an.AnalyticJacobian(cfg_j, colored_j,
                                                     q.theta_floats())


def _torch_g(q, th, c0, const, value):
    spec = control.ControlSpec("I")
    data = dict(th, _c0=torch.as_tensor(c0)[:, None], _const=torch.as_tensor(const),
                _v=torch.as_tensor(value)[:, None])

    def g(yy, d):
        return control.full_residual(spec, d["_v"][:, 0], 3.3, yy,
                                     d["_c0"] * yy + d["_const"], d, q.cfg)
    return g, data


def _dense(JS, colored):
    """The masked dense physics rows of one cell from the compressed form."""
    return np.asarray(JS)[colored.colors, :].T * colored._mask_body


def _assert_rows_close(Ja, Jb, tol):
    scale = np.abs(Jb).max(axis=1) + 1e-300
    err = (np.abs(Ja - Jb).max(axis=1) / scale)[:-1]
    assert err.max() < tol, (int(err.argmax()), err.max())


@pytest.mark.parametrize("theta_extra", [{}, {"R_film_n": 5e-4}],
                         ids=["published", "film_resistance"])
def test_compressed_matches_jax_and_colored(theta_extra, jax_analytic):
    """JS (as dense rows) and the control row equal the port's colored
    sweeps at 1e-12 of each row's scale, and, for the published θ, the JAX
    package's AnalyticJacobian.compressed at 1e-12 (with the film resistance
    the port's own sweeps are the reference)."""
    q, theta, plan, th, y, c0, const = _setup(theta_extra)
    value = np.array([0.8, -1.0])
    g, data = _torch_g(q, th, c0, const, value)
    yt = torch.as_tensor(y)
    JS_a, last_a = plan.analytic.compressed(3.3, yt, torch.as_tensor(c0), th, g, data)
    JS_c, last_c = plan.colored.compressed(g, yt, data)
    for i in range(B):
        Ja = _dense(JS_a[i].numpy(), plan.colored)
        _assert_rows_close(Ja, _dense(JS_c[i].numpy(), plan.colored), 1e-12)
        np.testing.assert_allclose(last_a[i].numpy(), last_c[i].numpy(),
                                   rtol=1e-12, atol=1e-15)
    if theta_extra:
        return

    cfg_j, colored_j, an_j = jax_analytic
    thj = {k: jnp.asarray(v, jnp.float64) for k, v in theta.items()}
    spec_j = jax_control.ControlSpec("I")

    @jax.jit
    def jax_side(y1, c01, const1, value1):
        def gj(yy):
            return jax_control.full_residual(spec_j, value1, 3.3, yy,
                                             c01 * yy + const1, thj, cfg_j)
        return an_j.compressed(3.3, y1, c01, thj, gj)

    for i in range(B):
        JS_j, last_j = jax_side(jnp.asarray(y[i]), c0[i], jnp.asarray(const[i]),
                                value[i])
        _assert_rows_close(_dense(JS_a[i].numpy(), plan.colored),
                           _dense(JS_j, colored_j), 1e-12)
        np.testing.assert_allclose(last_a[i].numpy(), np.asarray(last_j),
                                   rtol=1e-12, atol=1e-15)


def test_alg_block_matches_jax_and_colored(jax_analytic):
    """The consistent-init algebraic block equals the JAX package's
    alg_block at 1e-12 of each row's scale, and the port's colored
    factor_alg gives the same solves (1e-9, as tests/test_analytic.py)."""
    q, theta, plan, th, y, c0, const = _setup({})
    nd = q.cfg.layout.N_diff
    yt = torch.as_tensor(y)
    J = plan.analytic.alg_block(yt, th).numpy()
    an_j = jax_analytic[2]
    thj = {k: jnp.asarray(v, jnp.float64) for k, v in theta.items()}
    alg_j = jax.jit(lambda yy: an_j.alg_block(yy, thj))
    for i in range(B):
        Jj = np.asarray(alg_j(jnp.asarray(y[i])))
        assert np.abs(Jj[-1]).max() == np.abs(J[i, -1]).max() == 0.0
        _assert_rows_close(J[i], Jj, 1e-12)

    spec = control.ControlSpec("I")
    data = dict(th, _v=torch.full((B, 1), 0.8, dtype=torch.float64))

    def alg_res(y_alg, d):
        yy = torch.cat([d["_y_diff"], y_alg], dim=-1)
        return control.full_residual(spec, d["_v"][:, 0], 0.0, yy,
                                     torch.zeros_like(yy), d, q.cfg)[:, nd:]

    d = dict(data, _y_diff=yt[:, :nd])
    lu_a = plan.factor_alg(alg_res, yt[:, nd:], d, y_diff=yt[:, :nd], th=th)
    lu_c = plan.factor_alg(alg_res, yt[:, nd:], d)
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal((B, 71)))
    np.testing.assert_allclose(linsolve.equilibrated_inv_solve(lu_a, rhs).numpy(),
                               linsolve.equilibrated_inv_solve(lu_c, rhs).numpy(),
                               rtol=1e-9, atol=1e-12)


def test_consistent_init_with_analytic_block_matches_colored():
    """consistent_init given θ takes the analytic block; it converges in the
    same iterations to the colored init's y and yp (1e-10)."""
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    plan = get_plan(q.cfg, q.theta_floats(), Route())
    L, nd = q.cfg.layout, q.cfg.layout.N_diff
    th = {k: v.reshape(1, 1).repeat(B, 1) for k, v in q.theta.items()}
    th["D_sp"][1] = 1.3e-14
    spec = control.ControlSpec("I")
    data = dict(th, _v=torch.full((B, 1), -1.0, dtype=torch.float64))

    def F(t, y, yp, d):
        return control.full_residual(spec, d["_v"][:, 0], t, y, yp, d, q.cfg)

    y0 = initial_guess(torch.tensor([1.0, 0.6], dtype=torch.float64), th, q.cfg)
    y0[:, L.sl("I").start] = -1.0
    with torch.no_grad():
        a = consistent_init(F, y0, nd, data, jac_plan=plan, th=th)
        c = consistent_init(F, y0, nd, data, jac_plan=plan)
    assert bool(a.converged.all())
    assert a.iterations.tolist() == c.iterations.tolist()
    for u, v in ((a.y, c.y), (a.yp, c.yp)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(v.abs().max()))


def test_unsupported_configs_fall_back_to_colored():
    """No analytic assembly when the route asks for the sweeps or for a
    config outside JAX's scope (thermal, aging, the particle
    approximations, the half cell); the colored plan still factors. The
    spectral radial scheme is inside it, and a D_s that depends on the
    surface concentration gets its column of each particle block: the
    assembly equals the colored sweeps at 1e-12 of each row's scale."""
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    assert get_plan(q.cfg, q.theta_floats(), Route(analytic=False)).analytic is None

    def D_s_eff(c_s_p, c_s_n, T_p, T_n, th):
        return th["D_sp"] * (1.0 + 1e-6 * c_s_p), th["D_sn"] * torch.ones_like(c_s_n)

    cfg = ptt.ModelConfig.build(q.N, dataclasses.replace(q.numerics, D_s_eff=D_s_eff))
    plan = get_plan(cfg, q.theta_floats(), Route())
    assert plan.analytic is not None and plan.analytic.ds_dep
    _, theta, _, th, y, c0, const = _setup({})
    g, data = _torch_g(dataclasses.replace(q, cfg=cfg), th, c0, const,
                       np.array([0.8, -1.0]))
    yt = torch.as_tensor(y)
    JS_a, _ = plan.analytic.compressed(3.3, yt, torch.as_tensor(c0), th, g, data)
    JS_c, _ = plan.colored.compressed(g, yt, data)
    for i in range(B):
        _assert_rows_close(_dense(JS_a[i].numpy(), plan.colored),
                           _dense(JS_c[i].numpy(), plan.colored), 1e-12)
    for kw in (dict(temperature=True), dict(aging="SEI"), dict(aging="stress"),
               dict(solid_diffusion="quadratic"), dict(anode="Li_metal")):
        other = ptt.ModelConfig.build(q.N, ptt.Numerics(**kw))
        assert not analytic.AnalyticJacobian.supports(other), kw
    spectral = ptt.ModelConfig.build(q.N, ptt.Numerics(Fickian_method="spectral"))
    assert analytic.AnalyticJacobian.supports(spectral)


def test_route_reads_the_jax_environment_variables():
    """Route.from_env has the JAX package's defaults (analytic on, nested,
    blocks and D-chain off) and reads each variable when a plan is built;
    the plan cache is keyed on the route."""
    names = ("PETLION_JACA", "PETLION_NESTED", "PETLION_PALLAS_BLOCKS",
             "PETLION_PALLAS_DCHAIN")
    clean = {k: v for k, v in os.environ.items() if k not in names}
    with mock.patch.dict(os.environ, clean, clear=True):
        assert Route.from_env() == Route() == Route((), False, False, True)
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    th = q.theta_floats()
    env = dict(PETLION_JACA="0", PETLION_NESTED="j", PETLION_PALLAS_BLOCKS="1")
    with mock.patch.dict(os.environ, env):
        plan = get_plan(q.cfg, th)
    assert plan.route == Route(nested=("j",), blocks=True, analytic=False)
    assert plan.analytic is None and len(plan._specs[2]) == 1
    assert get_plan(q.cfg, th, plan.route) is plan
    assert get_plan(q.cfg, th, Route()) is not plan
    assert planmod._PATTERN_CACHE[(q.cfg, tuple(sorted(th)))] is not None
