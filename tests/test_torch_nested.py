"""The port's nested Schur factorization and its two kernels' plain versions
against the JAX package: the nested levels and their permutation, the XLA
nested factor/solve, the fused D-chain route (the TPU kernel run in
interpret mode), and K2/K3's plain versions against the Pallas kernels in
interpret mode (the kernels themselves on the card: tests/test_torch_cuda.py).
"""

import contextlib
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import petlion_tpu as pt
from petlion_tpu.ops import jacobian as jax_jac
from petlion_tpu.ops import pallas_gj, pallas_schur
from petlion_tpu.ops import plan as jax_plan
from petlion_tpu.ops import structured as jax_st
from petlion_tpu.solver import linsolve as jax_linsolve

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops import dchain as kd
from petlion_tpu_torch.ops import gj_blocks as kb
from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.ops import plan as planmod
from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE, Route, get_plan
from petlion_tpu_torch.ops.structured import SparseSchurP, sparse_schur_factor
from petlion_tpu_torch.physics.initial_guess import initial_guess
from petlion_tpu_torch.solver import control

torch.set_num_threads(1)

NESTED = Route(nested=("j", "Phi_s"), analytic=False)


@contextlib.contextmanager
def _nested_on():
    """PETLION_NESTED=1 with fresh plan caches of both packages, restoring
    the variable and the caches on exit."""
    old = os.environ.get("PETLION_NESTED")
    os.environ["PETLION_NESTED"] = "1"
    jax_plan._PLAN_CACHE.clear()
    planmod._PLAN_CACHE.clear()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PETLION_NESTED", None)
        else:
            os.environ["PETLION_NESTED"] = old
        jax_plan._PLAN_CACHE.clear()
        planmod._PLAN_CACHE.clear()


@contextlib.contextmanager
def _pallas_interpret():
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


@pytest.fixture(scope="module")
def newton():
    """Two cells' Newton matrices (float64) as the port's colored sweeps
    give them, with the JAX package's specs on the same pattern."""
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    plan = get_plan(q.cfg, q.theta_floats(), NESTED)
    L, B = q.cfg.layout, 2
    rng = np.random.default_rng(21)
    th = {k: v.reshape(1, 1).expand(B, 1) for k, v in q.theta.items()}
    y = initial_guess(torch.tensor([0.47, 0.81], dtype=torch.float64), th,
                      q.cfg).numpy()
    y *= 1.0 + 0.05 * rng.standard_normal(y.shape)
    y[:, L.sl("Phi_e")] = 0.02 * rng.standard_normal((B, 30))
    y[:, L.sl("j")] = 2e-6 * rng.standard_normal((B, 20))
    y[:, L.sl("I").start] = [0.7, -1.0]
    y = torch.as_tensor(y)
    c0 = torch.tensor([[0.37], [19.0]], dtype=torch.float64)
    data = dict(th, _c0=c0, _const=torch.as_tensor(
        1e-3 * rng.standard_normal(y.shape)) - c0 * y,
        _v=torch.tensor([[0.7], [-1.0]], dtype=torch.float64))
    spec = control.ControlSpec("I")

    def g(yy, d):
        return control.full_residual(spec, d["_v"][:, 0], 0.0, yy,
                                     d["_c0"] * yy + d["_const"], d, q.cfg)

    JS, last = plan.colored.compressed(g, y, data)
    colored_j = jax_jac.ColoredJacobian(plan.colored.pattern)
    split_j = jax_st.make_group_split(q.cfg.layout, plan.colored.pattern)
    specs_j = jax_st.make_sparse_specs(colored_j, split_j, q.cfg.layout,
                                       NESTED.nested)
    # the dense Newton matrices, for the reference solves
    J = JS[:, plan.colored.colors, :].transpose(1, 2) * torch.as_tensor(
        plan.colored._mask_body)
    J[:, -1] = last
    b = torch.as_tensor(rng.standard_normal(y.shape))
    return dict(q=q, plan=plan, JS=JS, last=last, J=J.numpy(), b=b,
                colored_j=colored_j, split_j=split_j, specs_j=specs_j)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _dense_err(x, J, b):
    """Relative error of x against numpy's solve of each cell's matrix."""
    errs = []
    for i in range(J.shape[0]):
        ref = np.linalg.solve(J[i], b[i])
        errs.append(np.linalg.norm(x[i] - ref) / np.linalg.norm(ref))
    return max(errs)


def test_nested_specs_and_pinfo_match_jax():
    """Under PETLION_NESTED=1 both packages' plans (fresh caches) eliminate
    j then Φ_s (core 71 → 51 → 31) at the same positions, with the same
    permutation and level sizes (20, 20); the control row stays last."""
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    with _nested_on():
        plan = get_plan(q.cfg, q.theta_floats())
        assert plan.route.nested == ("j", "Phi_s")
        ref = jax_plan.JacobianPlan(pt.petlion(pt.LCO).cfg, plan.colored.pattern)
    _, _, nested, (perm, sizes) = plan._specs
    _, _, nested_j, (perm_j, sizes_j) = ref._specs
    assert sizes == sizes_j == (20, 20)
    assert len(nested) == len(nested_j) == 2
    for (e, r), (ej, rj) in zip(nested, nested_j):
        np.testing.assert_array_equal(e, ej)
        np.testing.assert_array_equal(r, rj)
    assert [len(e) for e, _ in nested] == [20, 20]
    assert [len(r) for _, r in nested] == [51, 31]
    np.testing.assert_array_equal(perm, perm_j)
    assert sorted(perm.tolist()) == list(range(71)) and perm[-1] == 70
    assert plan.split.i_core[nested[0][1][nested[1][1][-1]]] == q.cfg.layout.N_tot - 1


def test_nested_factor_solve_matches_jax_xla(newton):
    """The port's nested factorization (levels, core inverse) and solve equal
    the JAX package's XLA nested path on the same sweeps at 1e-10, and the
    solve matches numpy's dense solve (< 1e-7, test_structured.py's bound)."""
    n = newton
    fac = sparse_schur_factor(n["JS"], n["last"], n["plan"].colored,
                              n["plan"].device_specs(n["JS"]))
    x = n["plan"].solve(fac, n["b"]).numpy()
    colored_j, split_j, specs_j = n["colored_j"], n["split_j"], n["specs_j"]

    @jax.jit
    def jax_side(JS, last, b):
        f = jax_st.sparse_schur_factor(JS, last, colored_j, specs_j, split_j)
        return f, jax_st.sparse_schur_solve(f, b, specs_j, split_j)

    for i in range(2):
        fj, xj = jax_side(jnp.asarray(n["JS"][i].numpy()),
                          jnp.asarray(n["last"][i].numpy()),
                          jnp.asarray(n["b"][i].numpy()))
        assert len(fac.levels) == len(fj.levels) == 2
        for lt, lj in zip(fac.levels, fj.levels):
            for a, w in zip(lt, lj):
                _close(a[i].numpy(), w, 1e-10)
        for a, w in zip(fac.core_inv, fj.core_inv):
            _close(a[i].numpy(), w, 1e-10)
        _close(x[i], xj, 1e-10)
    assert _dense_err(x, n["J"], n["b"].numpy()) < 1e-7


def test_fused_route_matches_jax_interpret(newton):
    """The port's fused route (K2 and K3's plain versions on the CPU)
    produces a SparseSchurP equal to the JAX package's fused route, run as
    tests/test_structured.py runs it (Pallas in interpret mode), at 1e-10;
    the solves agree, and match numpy's dense solve (< 1e-7)."""
    n = newton
    plan = n["plan"]
    gk.reset_launch_counts()
    fac = sparse_schur_factor(n["JS"], n["last"], plan.colored,
                              plan.device_specs(n["JS"]), blocks=True, dchain=True)
    assert isinstance(fac, SparseSchurP) and not any(gk.LAUNCHES.values())
    x = plan.solve(fac, n["b"]).numpy()
    colored_j, split_j, specs_j = n["colored_j"], n["split_j"], n["specs_j"]
    i = 1
    with _pallas_interpret(), \
            mock.patch.object(jax_linsolve, "_use_pallas_gj",
                              lambda J, min_n=17: J.ndim == 2
                              and J.shape[-1] >= min_n), \
            mock.patch.object(jax_st, "_PALLAS_DCHAIN", True):
        fj = jax.jit(lambda JS, last: jax_st.sparse_schur_factor(
            JS, last, colored_j, specs_j, split_j))(
            jnp.asarray(n["JS"][i].numpy()), jnp.asarray(n["last"][i].numpy()))
        xj = jax_st.sparse_schur_solve(fj, jnp.asarray(n["b"][i].numpy()),
                                       specs_j, split_j)
    assert type(fj).__name__ == "SparseSchurP"
    for gt, gj in zip(fac.groups, fj.groups):
        for a, w in zip(gt, gj):
            _close(a[i].numpy(), w, 1e-10)
    for lt, lj in zip(fac.levels, fj.levels):
        for a, w in zip(lt, lj):
            _close(a[i].numpy(), w, 1e-10)
    _close(fac.core_inv[i].numpy(), fj.core_inv, 1e-10)
    _close(x[i], xj, 1e-10)
    assert _dense_err(x, n["J"], n["b"].numpy()) < 1e-7


def test_gj_blocks_plain_matches_pallas_interpret():
    """K2's plain version in float32 against jax.vmap(gj_inverse_hot_blocks)
    in interpret mode at test_pallas_gj.py's shapes: within 1e-4 of each
    other and 2e-4 of the float64 inverse; a CPU tensor never launches."""
    rng = np.random.default_rng(3)
    gk.reset_launch_counts()
    with _pallas_interpret():
        for B, m, n in ((6, 20, 10), (4, 1, 30), (5, 2, 20)):
            A = (rng.standard_normal((B, m, n, n)) + 15 * np.eye(n)).astype(np.float32)
            pallas = np.asarray(jax.vmap(pallas_gj.gj_inverse_hot_blocks)(
                jnp.asarray(A)))
            ours = kb.gj_blocks_hot(torch.as_tensor(A)).numpy()
            ref = np.linalg.inv(A.astype(np.float64))
            np.testing.assert_allclose(ours, ref, atol=2e-4)
            np.testing.assert_allclose(ours, pallas, atol=1e-4)
    assert gk.LAUNCHES["gj_blocks"] == 0
    with pytest.raises(ValueError):
        kb.gj_blocks_cuda(torch.zeros(2, 10, 10))


def test_dchain_plain_matches_pallas_interpret():
    """K3's plain version in float32 against dchain_pallas in interpret mode
    at B = 5 (not a multiple of its 16-cell tile), on diagonally dominant
    cores with two levels and a remainder (n = 31, sizes (10, 10); the
    (71, (20, 20)) chain is compared in float64 by the fused-route test):
    every output within 1e-5 of its scale of the Pallas kernel's and 1e-4
    of the float64 chain's; a CPU tensor never launches."""
    rng = np.random.default_rng(8)
    n, sizes = 31, (10, 10)
    D = (0.3 * rng.standard_normal((5, n, n))
         + 15.0 * np.eye(n) * rng.uniform(0.1, 10.0, (5, 1, n)))
    gk.reset_launch_counts()
    with _pallas_interpret():
        pallas = pallas_schur.dchain_pallas(jnp.asarray(D, jnp.float32), sizes)
    ours = kd.dchain_hot(torch.as_tensor(D, dtype=torch.float32), sizes)
    ref = kd.dchain_plain(torch.as_tensor(D), sizes)
    assert [tuple(o.shape) for o in ours] == [(5,) + s for s in kd.out_shapes(n, sizes)]
    for a, w, r in zip(ours, pallas, ref):
        _close(a.numpy(), w, 1e-5)
        _close(a.double().numpy(), r.numpy(), 1e-4)
    assert gk.LAUNCHES["dchain"] == 0
    with pytest.raises(ValueError):
        kd.dchain_cuda(torch.zeros(2, 71, 71), (20, 20))


def test_full_kernel_route_runs_the_plain_data_flow_on_cpu():
    """On the CPU the full-kernel route (PETLION_NESTED=1, blocks, D-chain)
    is the environment's route and a factorization through it is a
    SparseSchurP whose solve equals the nested XLA route's at 1e-10, with
    no kernel launched."""
    q = ptt.petlion(ptt.LCO, device="cpu", dtype=torch.float64)
    env = dict(PETLION_NESTED="1", PETLION_PALLAS_BLOCKS="1",
               PETLION_PALLAS_DCHAIN="1", PETLION_JACA="1")
    with mock.patch.dict(os.environ, env):
        assert Route.from_env() == FULL_KERNEL_ROUTE
    full = get_plan(q.cfg, q.theta_floats(), FULL_KERNEL_ROUTE)
    nested = get_plan(q.cfg, q.theta_floats(), Route(nested=("j", "Phi_s")))
    assert full is not nested and full.analytic is not None
    rng = np.random.default_rng(2)
    L = q.cfg.layout
    th = {k: v.reshape(1, 1).expand(3, 1) for k, v in q.theta.items()}
    y = initial_guess(torch.tensor([0.3, 0.6, 0.9], dtype=torch.float64), th, q.cfg)
    y[:, L.sl("j")] = torch.as_tensor(1e-6 * rng.standard_normal((3, 20)))
    c0 = torch.tensor([0.1, 2.0, 40.0], dtype=torch.float64)
    data = dict(th, _c0=c0[:, None], _const=-c0[:, None] * y)
    spec = control.ControlSpec("I")

    def g(yy, d):
        return control.full_residual(spec, torch.full((3,), -1.0, dtype=yy.dtype),
                                     0.0, yy, d["_c0"] * yy + d["_const"], d, q.cfg)

    b = torch.as_tensor(rng.standard_normal(y.shape))
    gk.reset_launch_counts()
    facs = [pl_.factor_compressed(g, y, data, t=0.0, c0=c0, th=th)
            for pl_ in (full, nested)]
    assert isinstance(facs[0], SparseSchurP) and not any(gk.LAUNCHES.values())
    xs = [pl_.solve(f, b).numpy() for pl_, f in zip((full, nested), facs)]
    _close(xs[0], xs[1], 1e-10)
