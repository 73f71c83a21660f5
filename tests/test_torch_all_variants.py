"""Every isothermal physics variant of the port against the JAX package, in
float64 on the CPU, at the residual and Newton-matrix level: the residual
of each family of tests/test_residual_oracle.py (and the MHC, activity-
modified Butler-Volmer and nonlinear-transport closures) against JAX
`residual_core`; the port's assembled Newton matrix against `jax.jacfwd`
of JAX's residual; its factorization and solve on the default and the
full-kernel route against a dense solve; and `model_from_numpy` field by
field. Each JAX program here compiles in about a second."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petlion_tpu as pt
from petlion_tpu.physics import kinetics as jk
from petlion_tpu.physics import transport as jt
from petlion_tpu.physics.residuals import ModelConfig as JaxConfig
from petlion_tpu.physics.residuals import residual_core as jax_residual_core
from petlion_tpu.solver import control as jax_control

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE, Route, get_plan
from petlion_tpu_torch.physics import kinetics as tk
from petlion_tpu_torch.physics import transport as tt
from petlion_tpu_torch.solver import control
from test_residual_oracle import sample_state

torch.set_num_threads(1)

# (chemistry name, options): the isothermal families of the residual oracle
LAYOUTS = {
    "lco_spectral": ("LCO", dict(Fickian_method="spectral")),
    "lco_quadratic": ("LCO", dict(solid_diffusion="quadratic")),
    "lco_polynomial": ("LCO", dict(solid_diffusion="polynomial")),
    "lco_sei": ("LCO", dict(aging="SEI")),
    "lco_half_cell": ("LCO", dict(anode="Li_metal")),
    "nmc": ("NMC", {}),
    "nmc_sei": ("NMC", dict(aging="SEI")),
    "lgm50": ("NMC_LGM50", dict(temperature=False)),
    "lgm50_quadratic": ("NMC_LGM50", dict(temperature=False,
                                          solid_diffusion="quadratic")),
    "lgm50_stress": ("NMC_LGM50", dict(temperature=False, aging="stress")),
    "lgm50_stress_spectral": ("NMC_LGM50", dict(
        temperature=False, aging="stress", Fickian_method="spectral")),
}

# closures swapped into the LCO cell: (JAX numerics fields, port fields, θ)
CLOSURES = {
    "mhc": (dict(rxn_p=jk.rxn_MHC, rxn_n=jk.rxn_MHC),
            dict(rxn_p=tk.rxn_MHC, rxn_n=tk.rxn_MHC),
            dict(lambda_MHC_p=8.0, lambda_MHC_n=8.0)),
    "bv_gamma_mod_01": (dict(rxn_p=jk.rxn_BV_gamma_mod_01,
                             rxn_n=jk.rxn_BV_gamma_mod_01),
                        dict(rxn_p=tk.rxn_BV_gamma_mod_01,
                             rxn_n=tk.rxn_BV_gamma_mod_01), {}),
    "D_eff_thermodynamic_factor": (
        dict(D_eff=jt.D_eff, thermodynamic_factor=jt.thermodynamic_factor),
        dict(D_eff=tt.D_eff, thermodynamic_factor=tt.thermodynamic_factor), {}),
}


def _models(name):
    """(θ, JAX config, port model) of one family."""
    if name in CLOSURES:
        jfields, tfields, extra = CLOSURES[name]
        theta, _, _, N, numerics = pt.LCO()
        theta = dict(theta, **extra)
        jcfg = JaxConfig.build(N, dataclasses.replace(numerics, **jfields))
        _, bounds, opts, N_t, num_t = ptt.LCO()
        q = ptt.sim.make_model(theta, bounds, opts, N_t,
                               dataclasses.replace(num_t, **tfields),
                               device="cpu", dtype=torch.float64)
        return theta, jcfg, q
    chem, kw = LAYOUTS[name]
    theta, _, _, N, numerics = getattr(pt, chem)(**kw)
    q = ptt.petlion(getattr(ptt, chem), device="cpu", dtype=torch.float64, **kw)
    return theta, JaxConfig.build(N, numerics), q


def _theta_batch(q, B):
    return {k: v.reshape(1, 1).expand(B, 1) for k, v in q.theta.items()}


def _yp_like_oracle(y, th, jcfg, thj, seed):
    """yp ≠ 0 scaled per state family to the family's residual at yp = 0,
    as the residual oracle's comparison builds it."""
    L = jcfg.layout
    r0 = np.asarray(jax_residual_core(13.7, jnp.asarray(y), jnp.zeros(len(y)),
                                      thj, jcfg))
    rng = np.random.default_rng(seed)
    yp = np.zeros_like(y)
    for name, _ in L._entries:
        s = L.sl(name)
        yp[s] = (np.max(np.abs(r0[s])) + 1e-30) * rng.standard_normal(s.stop - s.start)
    return yp


@pytest.mark.parametrize("name", sorted(LAYOUTS) + sorted(CLOSURES))
def test_residual_matches_jax(name):
    """Two sampled states (I = 0.8 and −1.3), each with yp = 0 and with
    yp ≠ 0, in one batch of four cells: every state family of the port's
    residual lies within 1e-12 of JAX `residual_core`, relative to the
    family's largest magnitude."""
    theta, jcfg, q = _models(name)
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    ys, yps = [], []
    for seed, i_val in ((1, 0.8), (2, -1.3)):
        y = sample_state(theta, jcfg, seed, i_val=i_val)
        ys += [y, y]
        yps += [np.zeros_like(y), _yp_like_oracle(y, theta, jcfg, thj, seed + 1000)]
    ys, yps = np.stack(ys), np.stack(yps)
    got = ptt.residual_core(13.7, torch.as_tensor(ys), torch.as_tensor(yps),
                            _theta_batch(q, len(ys)), q.cfg).numpy()
    jres = jax.jit(lambda y, yp: jax_residual_core(13.7, y, yp, thj, jcfg))
    L = jcfg.layout
    assert q.cfg.layout.N_tot == L.N_tot
    for b in range(len(ys)):
        want = np.asarray(jres(jnp.asarray(ys[b]), jnp.asarray(yps[b])))
        for fam, _ in L._entries:
            s = L.sl(fam)
            err = np.max(np.abs(got[b, s] - want[s])) / (np.max(np.abs(want[s])) + 1e-300)
            assert err < 1e-12, (name, fam, b, err)


def _dense(plan, JS, last):
    """J[b, i, j] from the compressed layout (JS[b, color[j], i] on the
    pattern) and the exact control row."""
    col = plan.colored
    J = JS[:, col.colors, :].transpose(1, 2) * torch.as_tensor(col._mask_body)
    J[:, -1, :] = last
    return J


def _refined_solve(J, b):
    """Dense LU solve refined twice with a long-double residual (the
    unscaled Newton matrix has a condition number near 1e15)."""
    x = np.linalg.solve(J, b)
    Jl = J.astype(np.longdouble)
    for _ in range(2):
        r = b.astype(np.longdouble) - Jl @ x.astype(np.longdouble)
        x = x + np.linalg.solve(J, r.astype(np.float64))
    return x


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_newton_matrix_factor_and_solve(name):
    """Two cells at sampled states with their own c0 and setpoint: the
    Newton matrix that the port's plan assembles (closed forms where the
    analytic assembly covers the layout, else the colored sweeps) equals
    `jax.jacfwd` of JAX's full residual within 1e-10 of each row's scale
    (on the plan's sparsity pattern); the factorization on the default route
    and on the full-kernel route
    (nested j/Φ_s levels, K2 group inverses, K3 chain: their plain versions
    on the CPU) solves a random right-hand side within 1e-9 of a dense
    solve of that matrix."""
    theta, jcfg, q = _models(name)
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    ys = np.stack([sample_state(theta, jcfg, s, i_val=v)
                   for s, v in ((3, 0.9), (4, -0.7))])
    rng = np.random.default_rng(9)
    c0 = np.array([0.37, 1.9])
    const = 1e-3 * rng.standard_normal(ys.shape) * np.abs(ys)
    value = np.array([0.9, -0.7])
    rhs = rng.standard_normal(ys.shape)

    spec_j = jax_control.ControlSpec("I")

    @jax.jit
    def jax_jac(y, c0_, const_, v):
        return jax.jacfwd(lambda yy: jax_control.full_residual(
            spec_j, v, 0.0, yy, c0_ * yy + const_, thj, jcfg))(y)

    want = [np.asarray(jax_jac(jnp.asarray(ys[i]), c0[i], jnp.asarray(const[i]),
                               value[i])) for i in range(2)]

    spec = control.ControlSpec("I")
    data = _theta_batch(q, 2)
    data.update(_c0=torch.as_tensor(c0)[:, None], _const=torch.as_tensor(const),
                _v=torch.as_tensor(value)[:, None])

    def g(yy, d):
        return control.full_residual(spec, d["_v"][:, 0], 0.0, yy,
                                     d["_c0"] * yy + d["_const"], d, q.cfg)

    y_t = torch.as_tensor(ys)
    th = _theta_batch(q, 2)
    for route in (Route(), FULL_KERNEL_ROUTE):
        plan = get_plan(q.cfg, q.theta_floats(), route)
        assert (plan.analytic is not None) == \
            ptt.ops.analytic.AnalyticJacobian.supports(q.cfg)
        if plan.analytic is not None:
            JS, last = plan.analytic.compressed(0.0, y_t, torch.as_tensor(c0), th,
                                                g, data)
        else:
            JS, last = plan.colored.compressed(g, y_t, data)
        J = _dense(plan, JS, last).numpy()
        fac = plan.factor_compressed(g, y_t, data, t=torch.zeros(2),
                                     c0=torch.as_tensor(c0), th=th)
        x = plan.solve(fac, torch.as_tensor(rhs)).numpy()
        pat = plan.colored.pattern
        eps_s = q.cfg.layout.sl("eps_s") if "eps_s" in q.cfg.layout else slice(0, 0)
        for i in range(2):
            scale = np.abs(want[i]).max(axis=1, keepdims=True)
            assert np.max(np.abs(J[i] - want[i] * pat) / scale) < 1e-10, (name, route)
            # off the pattern, above the rounding residue of differentiating
            # the particle mean shift: only the ⟨σ_h⟩₊-gated ε_s rows, where
            # σ_h ≤ 0 at the pattern's sample states (the JAX package's plan
            # samples the same states and leaves the same entries out)
            off = (np.abs(want[i]) > 1e-12 * scale) & ~pat
            rows = np.nonzero(off.any(axis=1))[0]
            assert all(eps_s.start <= r < eps_s.stop for r in rows), (name, rows)
            ref = _refined_solve(J[i], rhs[i])
            err = np.linalg.norm(x[i] - ref) / np.linalg.norm(ref)
            assert err < 1e-9, (name, route, err)


@pytest.mark.parametrize("name", sorted(LAYOUTS) + sorted(CLOSURES))
def test_every_family_runs(name):
    """Each family runs through the port's entry points on the CPU in
    float64: `simulate` (10 s at 1C from SOC 0.8), `simulate_cont` (5 s of
    rest) and `batch_simulate` (two cells from SOC 0.8 and 0.6, 5 s), each
    to tf with finite states and the SOC falling while discharging."""
    _, _, q = _models(name)
    sol = ptt.simulate(q, 10.0, I=-1, SOC=0.8)
    sol = ptt.simulate_cont(sol, q, 5.0, I="rest")
    assert sol.exit_reasons() == ["Final time reached"] * 2
    assert np.isfinite(sol.Y_final).all() and sol.t[-1] == pytest.approx(15.0)
    assert sol.SOC[sol.results[0].run_index][-1] < 0.8
    res = ptt.batch_simulate(q, 5.0, n_cells=2, I=-1.0, SOC=np.array([0.8, 0.6]))
    assert res.flag.tolist() == [0, 0] and torch.isfinite(res.y_final).all()
    assert (res.soc_final.numpy() < [0.8, 0.6]).all()


@pytest.mark.parametrize("chem, kw", [("NMC", dict(aging="SEI")),
                                      ("LCO", dict(anode="Li_metal"))],
                         ids=["nmc_sei", "lco_half_cell"])
def test_model_from_numpy_round_trip(chem, kw):
    """A JAX model carried across by `model_from_numpy` equals the port's own
    model field by field: θ, bounds, options, mesh, numerics (each physics
    function the port's of the same name) and layout."""
    pj = pt.petlion(getattr(pt, chem), **kw)
    m = ptt.model_from_numpy({k: np.asarray(v) for k, v in pj.theta.items()},
                             pj.bounds, pj.N, pj.numerics, opts=pj.opts,
                             device="cpu", dtype=torch.float64)
    q = ptt.petlion(getattr(ptt, chem), device="cpu", dtype=torch.float64, **kw)
    assert m.theta.keys() == q.theta.keys() == pj.theta.keys()
    for k in q.theta:
        assert float(m.theta[k]) == float(q.theta[k]) == float(pj.theta[k]), k
    for a, b in ((m.bounds, q.bounds), (m.opts, q.opts), (m.N, q.N)):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            assert va == vb or (va != va and vb != vb), f.name
    for f in dataclasses.fields(m.numerics):
        va, vj = getattr(m.numerics, f.name), getattr(pj.numerics, f.name)
        assert va is getattr(q.numerics, f.name), f.name
        if callable(va):
            assert va.__module__.startswith("petlion_tpu_torch.")
            assert va.__name__ == vj.__name__, f.name
        else:
            assert va == vj, f.name
    assert m.cfg.layout == q.cfg.layout
    assert m.cfg.layout.N_tot == pj.cfg.layout.N_tot


@pytest.mark.parametrize("name", ["lco_half_cell", "nmc_sei"])
def test_state_functions_match_jax(name):
    """On a sampled state: V, η_plating, the SOC estimate from the state
    (from the cathode in a half cell), `calc_OCV` (the foil's 0 V as U_n in
    a half cell) and `calc_R_internal` equal the JAX package's (the last to
    1e-10: it divides a difference of nearly equal voltages)."""
    theta, jcfg, q = _models(name)
    chem, kw = LAYOUTS[name]
    pj = pt.petlion(getattr(pt, chem), **kw)
    y = sample_state(theta, jcfg, 5, i_val=-0.9)
    thj = {k: jnp.asarray(float(v), jnp.float64) for k, v in theta.items()}
    L, Lj = q.cfg.layout, jcfg.layout
    yt = torch.as_tensor(y)[None]
    th = _theta_batch(q, 1)
    for ours, theirs in ((L.V(yt), Lj.V(y)), (L.eta_plating(yt), Lj.eta_plating(y)),
                         (L.soc_from_state(yt, th), Lj.soc_from_state(y, thj))):
        np.testing.assert_allclose(ours.numpy()[0], np.asarray(theirs), rtol=1e-13)
    for ours, theirs in zip(ptt.calc_OCV(y, q), pt.calc_OCV(y, pj)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-13, atol=1e-15)
    # |V − OCV| / |I|: V and the OCV cancel to about 1e-4 of their size
    np.testing.assert_allclose(float(ptt.calc_R_internal(y, q)),
                               float(pt.calc_R_internal(y, pj)), rtol=1e-10)


@pytest.mark.parametrize("chem, kw", [
    ("NMC", {}), ("NMC_LGM50", {}), ("LCO", dict(anode="Li_metal")),
    ("NMC_LGM50", dict(anode="Li_metal", temperature=False))],
    ids=["nmc", "lgm50", "lco_half_cell", "lgm50_half_cell"])
def test_chemistry_matches_jax(chem, kw):
    """The chemistry function's θ, bounds, options, mesh and numerics (each
    physics function by name) equal the JAX package's."""
    th_j, b_j, o_j, N_j, num_j = getattr(pt, chem)(**kw)
    th_t, b_t, o_t, N_t, num_t = getattr(ptt, chem)(**kw)
    assert th_t == th_j
    for a, b in ((b_t, b_j), (o_t, o_j), (N_t, N_j)):
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            assert va == vb or (va != va and vb != vb), f.name
    for f in dataclasses.fields(num_j):
        vj, vt = getattr(num_j, f.name), getattr(num_t, f.name)
        assert (vt.__name__ == vj.__name__) if callable(vj) else (vt == vj), f.name
