"""Parameter estimation on the port, on the CPU in float64: the kernels'
forward-mode tangent Functions (K1ᵗ/K2's `gj_kernel.Inverse`, K3ᵗ's
`dchain.Chain`, here through their plain versions) against `jax.jvp` of
the JAX package's CPU functions, and `estimation.sensitivities` on the
inputs of tests/test_estimation.py:18 against the port's own central
difference and on the full-kernel route. Slow: the same sensitivities
against the JAX package's (one forward-mode program through its solver,
run once per session through tests/torch_shared.py) and the Gauss–Newton
recovery of tests/test_estimation.py:31 on the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import petlion_tpu as pt
from petlion_tpu import estimation as jax_estimation
from petlion_tpu.ops import structured as jax_structured
from petlion_tpu.solver import linsolve as jax_linsolve

import petlion_tpu_torch as ptt
from petlion_tpu_torch import estimation, main_path
from petlion_tpu_torch.ops import dchain as kd
from petlion_tpu_torch.ops import dual
from petlion_tpu_torch.ops import gj_blocks as kb
from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE
from petlion_tpu_torch.runtime import native
from petlion_tpu_torch.solver import linsolve
from torch_shared import shared

torch.set_num_threads(1)

# the inputs of the JAX package's tests/test_estimation.py:18
T_EVAL = np.array([100.0, 300.0, 550.0])
SENS_KW = dict(I_crate=-1.0, SOC=0.5)


def _equilibrated(B, n, seed):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.standard_normal((B, n, n)) + 20.0 * np.eye(n))
    return linsolve._equilibrate(A)[0], torch.as_tensor(rng.standard_normal((B, n, n)))


def _jvp(fn, x, dx):
    """(fn(x), its tangent along dx) of a port function by forward mode."""
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(x, dx))
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [fwAD.unpack_dual(o) for o in outs]
        return [p.primal.clone() for p in pairs], [p.tangent.clone() for p in pairs]


# one compile per shape: far quicker than dispatching the pivot loops op by op
@jax.jit
def _jax_inverse_jvp(A, dA):
    return jax.jvp(jax_linsolve.gj_inverse_blocked, (A,), (dA,))[1]


@pytest.mark.parametrize("n", [10, 30, 71])
def test_inverse_tangent_matches_jax_jvp(n):
    """K1's dispatch (n = 71) and K2's (n = 10 and 30) with a dual input:
    the tangent −X·dA·X of `gj_kernel.Inverse` equals `jax.jvp` of the JAX
    package's `linsolve.gj_inverse_blocked` (what its solver differentiates
    off the TPU) within 1e-10 of the tangent's scale, and the inverse is
    the plain dispatch's bit for bit."""
    A, dA = _equilibrated(3, n, seed=n)
    hot = kb.gj_blocks_hot if n < 71 else gk.gj_inverse_hot
    (X,), (dX,) = _jvp(hot, A, dA)
    assert torch.equal(X, hot(A))
    want = np.asarray(_jax_inverse_jvp(jnp.asarray(A.numpy()), jnp.asarray(dA.numpy())))
    assert np.abs(dX.numpy() - want).max() <= 1e-10 * np.abs(want).max()


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


def test_chain_tangent_matches_jax_jvp():
    """K3's dispatch with a dual core: on the permuted Schur cores of real
    Newton matrices (levels (20, 20), the Φ_s level nearly singular) and a
    tangent of the cores' own pattern, every output's tangent from
    `dchain.Chain` (`dchain_tangent_plain`) equals `jax.jvp` of the JAX
    package's CPU chain within 1e-10 of that tangent's scale."""
    _, Dp, sizes, _ = main_path.newton_matrices(n_states=4)
    dD = Dp * torch.as_tensor(np.random.default_rng(5).standard_normal(Dp.shape))
    prim, tan = _jvp(lambda D: kd.dchain_hot(D, sizes), Dp, dD)
    for a, b in zip(prim, kd.dchain_plain(Dp, sizes)):
        assert torch.equal(a, b)
    want = _jax_chain_jvp(jnp.asarray(Dp.numpy()), jnp.asarray(dD.numpy()), sizes)
    for got, w in zip(tan, want):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-10 * np.abs(w).max()


@pytest.mark.parametrize("kind", ["inverse", "chain"])
def test_tangent_functions_pass_forward_gradcheck(kind):
    """`torch.autograd.gradcheck` in forward mode (backward mode is not
    defined: the port, as JAX's jacfwd, takes forward mode only)."""
    if kind == "inverse":
        A = _equilibrated(2, 12, seed=1)[0].requires_grad_(True)
        fn = gk.gj_inverse_hot
    else:
        rng = np.random.default_rng(2)
        A = torch.as_tensor(rng.standard_normal((2, 14, 14)) + 15.0 * np.eye(14))
        A.requires_grad_(True)

        def fn(D):
            return kd.dchain_hot(D, (4, 5))
    assert torch.autograd.gradcheck(fn, (A,), check_forward_ad=True,
                                    check_backward_ad=False, check_undefined_grad=False,
                                    check_batched_grad=False)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# operands of a meta add and mul: a Python number, broadcasting, a
# transposed operand, an integer against a 0-dim float, a 0-dim float64
# against float16
META_OPERANDS = {
    "f32_python_float": lambda: (_meta(3, 4), 2.5),
    "f32_python_int": lambda: (_meta(2, 3), 3),
    "broadcast_f32_f64": lambda: (_meta(3, 1), _meta(4, dtype=torch.float64)),
    "transposed": lambda: (_meta(4, 3).t(), _meta(3, 4)),
    "int_vs_0dim_f32": lambda: (_meta(2, dtype=torch.int64), _meta()),
    "f16_vs_0dim_f64": lambda: (_meta(2, 3, dtype=torch.float16),
                                _meta(dtype=torch.float64)),
}


@pytest.mark.parametrize("case", sorted(META_OPERANDS))
def test_fast_zero_tangents_restores_meta_kernels(case):
    """`dual.fast_zero_tangents` swaps the meta kernels of aten add and mul
    for the run: inside, a meta add or mul has PyTorch's shape and dtype;
    after, PyTorch's own kernels give the shapes, strides and dtypes they
    gave before; a second entry while it is on raises and leaves it on."""
    a, b = META_OPERANDS[case]()

    def read():
        return [(tuple(o.shape), o.stride(), o.dtype)
                for o in (torch.add(a, b), torch.add(a, b, alpha=2), torch.mul(a, b))]

    before = read()
    with dual.fast_zero_tangents():
        inside = read()
        with pytest.raises(RuntimeError, match="does not nest"):
            with dual.fast_zero_tangents():
                pass
        assert read() == inside
    assert [(s, d) for s, _, d in inside] == [(s, d) for s, _, d in before]
    assert read() == before


def test_tangent_guards_raise():
    """A dual tensor that reaches a ctypes wrapper raises, before anything
    else is checked: the kernels and the native spline would drop its
    tangent. Without a tangent the same CPU tensors fail on the device."""
    A, dA = _equilibrated(2, 10, seed=3)
    with fwAD.dual_level():
        Ad = fwAD.make_dual(A, dA)
        for call in (lambda: gk.gj_inverse_cuda(Ad), lambda: kb.gj_blocks_cuda(Ad),
                     lambda: kd.dchain_cuda(Ad, (4,)), lambda: gk.gj_tangent_cuda(A, Ad),
                     lambda: kd.dchain_tangent_cuda(Ad, dA, (), ()),
                     lambda: native.spline_interp(Ad[0, 0], Ad[0, 1], Ad[0, 0])):
            with pytest.raises(ValueError, match="tangent"):
                call()
    with pytest.raises(ValueError, match="CUDA"):
        gk.gj_inverse_cuda(A)


@pytest.fixture(scope="module")
def p():
    return ptt.petlion(ptt.LCO, device="cpu")


@pytest.fixture(scope="module")
def port_sens(p):
    """The port's sensitivities, value and Jacobian, on the default route."""
    voltage, th0 = estimation.make_voltage_model(p, ["D_sp"], t_eval=T_EVAL, **SENS_KW)
    V, J, _ = estimation.value_and_jacobian(voltage, th0)
    return voltage, th0, V, J


def _jax_sensitivities():
    """∂V/∂D_sp and θ0 of the JAX package on the inputs of its
    tests/test_estimation.py:18: the forward-mode derivative through its
    solver of its `make_voltage_model`'s voltage, by `jax.jvp` along the one
    parameter (what its `sensitivities`' `jax.jacfwd` computes for k = 1)
    under one `jax.jit`, as its `fit` runs the Jacobian. Its `sensitivities`
    as written (`jax.jacfwd` outside a jit) takes 130–150 s here; this
    program 50–55 s, 2e-12 apart from it."""
    voltage, th0 = jax_estimation.make_voltage_model(pt.petlion(pt.LCO), ["D_sp"],
                                                     t_eval=T_EVAL, **SENS_KW)
    dV = jax.jit(lambda x: jax.jvp(voltage, (x,), (jnp.ones_like(x),))[1])(th0)
    return np.asarray(dV)[:, None], np.asarray(th0)


@pytest.mark.slow
def test_sensitivities_match_jax(port_sens, p, request):
    """∂V/∂D_sp at 100, 300 and 550 s of a 1C discharge from SOC 0.5 equals
    the JAX package's forward-mode derivative through its solver
    (`_jax_sensitivities`, the one JAX program of the file) within rtol
    1e-6 (measured on the CPU: 1.5e-10), at the same θ0; every entry
    nonzero. Slow: its 64–71 s of JAX tracing and compiling would take the
    file's default tests to 114–123 s in one process on the CPU."""
    want = shared(request, "estimation_sensitivities", _jax_sensitivities)
    J = port_sens[3].numpy()
    np.testing.assert_allclose(J, want[0], rtol=1e-6)
    np.testing.assert_allclose(port_sens[1].numpy(), want[1], rtol=0)
    assert np.all(np.abs(J) > 0)


def test_sensitivities_match_central_difference(port_sens):
    """The JAX package's check (tests/test_estimation.py:18) on the port: the
    forward-mode Jacobian against the port's central difference (ε = 1e-18
    on D_sp = 1e-14), rtol 1e-5 (measured: 8.4e-7); and the dual run's value
    equals the one-row voltage at θ0 within 1e-12 relative."""
    voltage, th0, V, J = port_sens
    V0 = voltage(th0)
    np.testing.assert_allclose(V.numpy(), V0.numpy(), rtol=1e-12)
    eps = 1e-18
    Vpm = voltage(torch.stack([th0 + eps, th0 - eps]))      # two cells, one run
    fd = (Vpm[0] - Vpm[1]) / (2 * eps)
    np.testing.assert_allclose(J[:, 0].numpy(), fd.numpy(), rtol=1e-5)


def test_voltage_matches_simulate(port_sens, p):
    """The voltage model's value is the trace of a plain `simulate` of the
    same run (its tf, tolerances and max_save) read at t_eval by linear
    interpolation, within 1e-12 relative."""
    voltage, th0, V, _ = port_sens
    sol = ptt.simulate(p, voltage.tf, I=-1.0, SOC=0.5, reltol=1e-5, abstol=1e-7,
                       max_save=512)
    np.testing.assert_allclose(V.numpy(), np.interp(T_EVAL, sol.t, sol.V), rtol=1e-12)


def test_full_kernel_route_matches_default(port_sens, p):
    """The sensitivities on the full-kernel route (nested levels, K2's and
    K3's tangents, here their plain versions) agree with the default route
    (K1's) within rtol 1e-7 (measured: 1.5e-10)."""
    J, th0 = estimation.sensitivities(p, ["D_sp"], T_EVAL, route=FULL_KERNEL_ROUTE,
                                      **SENS_KW)
    np.testing.assert_allclose(J, port_sens[3].numpy(), rtol=1e-7)


@pytest.mark.slow
def test_gauss_newton_recovers_parameters():
    """The JAX package's tests/test_estimation.py:31 on the port: synthetic
    data at {D_sp: 1.7e-14, k_n: 3.1e-11}, 24 points on 60–1700 s of a 1C
    discharge from SOC 0.9, fitted from (1e-14, 5.031e-11) in 10
    Gauss–Newton iterations: both within 1e-3."""
    p = ptt.petlion(ptt.LCO, device="cpu")
    true = {"D_sp": 1.7e-14, "k_n": 3.1e-11}
    t_data = np.linspace(60.0, 1700.0, 24)
    for k, v in true.items():
        p.theta[k] = torch.tensor(v, dtype=p.dtype)
    voltage, th_true = estimation.make_voltage_model(p, list(true), t_eval=t_data,
                                                     I_crate=-1.0, SOC=0.9)
    V_data = voltage(th_true).numpy()
    p.theta["D_sp"] = torch.tensor(1e-14, dtype=p.dtype)
    p.theta["k_n"] = torch.tensor(5.031e-11, dtype=p.dtype)
    fitted = estimation.fit(p, list(true), t_data, V_data, I_crate=-1.0, SOC=0.9,
                            iters=10)
    for k, v in true.items():
        assert abs(fitted[k] - v) / v < 1e-3, (k, fitted[k], v)
