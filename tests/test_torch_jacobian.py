"""The port's sparsity plan, colored Jacobian and Schur factor/solve against
the JAX package, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
from petlion_tpu.ops import jacobian as jax_jac
from petlion_tpu.ops import structured as jax_st
from petlion_tpu.physics.initial_guess import initial_guess as jax_initial_guess
from petlion_tpu.physics.residuals import residual_core as jax_residual_core
from petlion_tpu.solver import control as jax_control

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops.plan import get_plan
from petlion_tpu_torch.solver import control
from test_residual_oracle import sample_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    p = pt.petlion(pt.LCO)
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    plan = get_plan(q.cfg, q.theta_floats())
    thj = {k: jnp.asarray(v, jnp.float64) for k, v in p.theta.items()}
    return p, q, plan, thj


def _get_plan_samples(p, thj):
    """The randomized states at which get_plan detects the pattern (the JAX
    package's plan.py sampler, for the LCO config)."""
    L = p.cfg.layout
    out = []
    for soc, ival, seed, t in ((0.41, 0.7, 1, 13.7), (0.83, -0.6, 2, 507.1)):
        y = np.asarray(jax_initial_guess(soc, thj, p.cfg, jnp.float64)).copy()
        r = np.random.default_rng(seed)
        y *= (1.0 + 0.05 * r.standard_normal(y.shape))
        y[L.sl("Phi_e")] = 0.01 * r.standard_normal(y[L.sl("Phi_e")].shape)
        y[L.sl("j")] = 1e-6 * r.standard_normal(y[L.sl("j")].shape)
        y[L.sl("I").start] = ival
        yp = 1e-3 * r.standard_normal(y.shape)
        out.append((t, y, yp))
    return out


def test_pattern_colors_and_split_match_jax(setup):
    """The port's pattern equals the structural nonzeros of the JAX
    Jacobian at get_plan's sample states (above 1e-12 of the row's scale:
    below it sit only the rounding residues of differentiating the exact
    particle mean shift, which the port keeps out of its AD graph), and the
    coloring and elimination split equal the JAX package's on it."""
    p, q, plan, thj = setup
    cfg = p.cfg
    jac = jax.jit(jax.jacfwd(
        lambda y, yp, t: jax_residual_core(t, y, yp, thj, cfg), argnums=(0, 1)))
    pat = np.zeros((301, 301), bool)
    for t, y, yp in _get_plan_samples(p, thj):
        for J in jac(jnp.asarray(y), jnp.asarray(yp), t):
            J = np.abs(np.asarray(J))
            pat |= J > 1e-12 * J.max(axis=1, keepdims=True)
    pat[np.arange(230), np.arange(230)] = True
    ours = plan.colored.pattern
    np.testing.assert_array_equal(ours[:-1], pat[:-1])
    assert ours[-1].all()          # control row: dense by construction

    colors, n_colors = jax_jac.greedy_color(ours)
    np.testing.assert_array_equal(plan.colored.colors, colors)
    assert plan.n_colors == n_colors == 10
    split = jax_st.make_group_split(cfg.layout, ours)
    np.testing.assert_array_equal(plan.split.i_core, split.i_core)
    assert len(plan.split.i_core) == 71
    for a, b in zip(plan.split.group_rows, split.group_rows):
        np.testing.assert_array_equal(a, b)


def _newton_setup(p, q, thj, seeds=(3, 4)):
    """Two cells at off-equilibrium states with their own c0 and psi."""
    ys = np.stack([sample_state(p.theta, p.cfg, seed=s) for s in seeds])
    rng = np.random.default_rng(9)
    c0 = np.array([0.37, 1.9])
    const = 1e-3 * rng.standard_normal(ys.shape) * np.abs(ys)
    value = np.array([-1.0, 0.3])
    return ys, c0, const, value


def _jax_g(p, thj, c0, const, value):
    spec = jax_control.ControlSpec("I")

    def g(y):
        return jax_control.full_residual(spec, value, 0.0, y, c0 * y + const,
                                         thj, p.cfg)
    return g


def _torch_g(q, ys, c0, const, value):
    spec = control.ControlSpec("I")
    data = {k: v.reshape(1, 1).expand(len(ys), 1) for k, v in q.theta.items()}
    data.update(_c0=torch.as_tensor(c0)[:, None], _const=torch.as_tensor(const),
                _v=torch.as_tensor(value)[:, None])

    def g(yy, d):
        return control.full_residual(spec, d["_v"][:, 0], 0.0, yy,
                                     d["_c0"] * yy + d["_const"], d, q.cfg)
    return g, data


def test_compressed_and_schur_solve_match_jax(setup):
    """Colored sweeps and control row equal JAX's ColoredJacobian.compressed
    on the same coloring at 1e-10; the Schur solve equals JAX's
    sparse_schur_solve and a (refined) dense solve of the Newton matrix at
    1e-9 relative."""
    p, q, plan, thj = setup
    ys, c0, const, value = _newton_setup(p, q, thj)
    g_t, data = _torch_g(q, ys, c0, const, value)
    y_t = torch.as_tensor(ys)
    JS_t, last_t = plan.colored.compressed(g_t, y_t, data)
    fac_t = plan.factor_compressed(g_t, y_t, data)
    rng = np.random.default_rng(13)
    b = rng.standard_normal(ys.shape)
    x_t = plan.solve(fac_t, torch.as_tensor(b)).numpy()

    colored_j = jax_jac.ColoredJacobian(plan.colored.pattern)
    split_j = jax_st.make_group_split(p.cfg.layout, plan.colored.pattern)
    specs_j = jax_st.make_sparse_specs(colored_j, split_j, p.cfg.layout, ())

    @jax.jit
    def jax_side(y, c0_, const_, value_, b_):
        g_j = _jax_g(p, thj, c0_, const_, value_)
        JS_j, last_j = colored_j.compressed(g_j, y)
        fac_j = jax_st.sparse_schur_factor(JS_j, last_j, colored_j, specs_j,
                                           split_j)
        x_j = jax_st.sparse_schur_solve(fac_j, b_, specs_j, split_j)
        return JS_j, last_j, x_j, jax.jacfwd(g_j)(y)

    for i in range(len(ys)):
        JS_j, last_j, x_j, J_dense = (np.asarray(a) for a in jax_side(
            jnp.asarray(ys[i]), c0[i], jnp.asarray(const[i]), value[i],
            jnp.asarray(b[i])))
        np.testing.assert_allclose(JS_t[i].numpy(), JS_j, rtol=1e-10,
                                   atol=1e-10 * np.abs(JS_j).max())
        np.testing.assert_allclose(last_t[i].numpy(), last_j, rtol=1e-10,
                                   atol=1e-12)
        # the unscaled Newton matrix has cond ~1e15: refine the dense LU
        # solve twice with a long-double residual so the reference is exact
        # to far below the tolerance
        x_dense = np.linalg.solve(J_dense, b[i])
        Jl = J_dense.astype(np.longdouble)
        for _ in range(2):
            r = b[i].astype(np.longdouble) - Jl @ x_dense.astype(np.longdouble)
            x_dense = x_dense + np.linalg.solve(J_dense, r.astype(np.float64))
        for ref in (x_j, x_dense):
            err = np.linalg.norm(x_t[i] - ref) / np.linalg.norm(ref)
            assert err < 1e-9, err


@pytest.mark.slow
def test_pattern_against_jax_get_plan(setup, monkeypatch):
    """Against the JAX package's own get_plan: its pattern contains the
    port's, and every extra entry lies inside one particle's radial block,
    where the JAX Jacobian is below 1e-12 of the row's scale (the rounding
    residue of differentiating the exact mean shift)."""
    from petlion_tpu.ops import plan as jax_plan
    p, q, plan, thj = setup
    monkeypatch.setenv("PETLION_JACA", "0")
    monkeypatch.setattr(jax_plan, "_PLAN_CACHE", {})
    theirs = jax_plan.get_plan(p.cfg, p.theta).colored.pattern
    ours = plan.colored.pattern
    assert not (ours & ~theirs).any()
    extra = np.argwhere(theirs & ~ours)
    cs = p.cfg.layout.sl("c_s_avg")
    for i, j in extra:
        assert cs.start <= i < cs.stop and cs.start <= j < cs.stop
        assert (i - cs.start) // 10 == (j - cs.start) // 10
    jac = jax.jit(jax.jacfwd(
        lambda y, yp, t: jax_residual_core(t, y, yp, thj, p.cfg), argnums=(0, 1)))
    for t, y, yp in _get_plan_samples(p, thj):
        for J in jac(jnp.asarray(y), jnp.asarray(yp), t):
            J = np.abs(np.asarray(J))
            rel = J[extra[:, 0], extra[:, 1]] / J.max(axis=1)[extra[:, 0]]
            assert rel.max() < 1e-12
