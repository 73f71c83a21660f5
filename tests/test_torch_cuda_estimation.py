"""Parameter estimation on the card: the tangent kernels K1ᵗ
(csrc/gj_tangent.cu) and K3ᵗ (csrc/dchain_tangent.cu) against their plain
versions, and `estimation.sensitivities` on the card against the port on
the CPU. They skip where torch.cuda.is_available() is False. This file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_estimation.py
"""

import numpy as np
import pytest
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch import estimation, main_path
from petlion_tpu_torch.ops import dchain as kd
from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE
from petlion_tpu_torch.solver import linsolve

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _scaled_err(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


# path 14's shapes ((a): one or two fitted parameters at n = 71; (b): 10 or
# 20 particle blocks and one or two c_e blocks), the timed large ones, and B
# on both sides of the launch plan's regime threshold (B·⌈n/16⌉ against 132
# SMs) at n = 17, 71, 128 and 169
@pytest.mark.parametrize("B, n", [(1, 71), (2, 71), (1024, 71), (10240, 10), (1024, 30),
                                  (3, 17), (5, 101), (2, 128), (3, 169),
                                  (10, 10), (1, 30), (20, 10), (2, 30),
                                  (66, 17), (67, 17), (26, 71), (27, 71), (16, 128), (17, 128),
                                  (12, 169), (13, 169)])
def test_gj_tangent_matches_plain_on_card(B, n):
    """K1ᵗ (dX = −X·dA·X) against its plain version: in float64 within 1e-10
    of the tangent's scale; in float32 its error against float64 at most 4×
    the plain float32 version's plus 1e-5 (K1's rule). Each launch counts
    once, by n, and takes the instance its launch plan names, with the
    plan's shared memory and threads."""
    _need_card()
    rng = np.random.default_rng(B * 1000 + n)
    A = torch.as_tensor(rng.standard_normal((B, n, n)) + 20.0 * np.eye(n), device="cuda")
    A = linsolve._equilibrate(A)[0]
    dA = torch.as_tensor(rng.standard_normal((B, n, n)), device="cuda")
    X = torch.linalg.inv(A)
    ref = gk.gj_tangent_plain(X, dA)
    dtypes = ((torch.float64, torch.float32) if n <= gk.MAX_N[torch.float64]
              else (torch.float32,))
    for dtype in dtypes:
        plan = gk.gj_tangent_plan(B, n, dtype)
        assert gk.gj_tangent_block(plan, dtype) == (plan.smem, plan.threads), plan
        before = gk.LAUNCHES_BY_N["gj_tangent"].get(n, 0)
        got = gk.gj_tangent_hot(X.to(dtype), dA.to(dtype))
        assert gk.LAUNCHES_BY_N["gj_tangent"][n] == before + 1
        err = _scaled_err(got, ref)
        if dtype == torch.float64:
            assert err <= 1e-10, err
        else:
            plain = _scaled_err(gk.gj_tangent_plain(X.float(), dA.float()), ref)
            assert err <= 4 * plain + 1e-5, (err, plain)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B", [1, 2, 5, 1024])
def test_dchain_tangent_matches_plain_on_card(B, dtype):
    """K3ᵗ on the permuted Schur cores of real Newton matrices (levels (20,
    20)) tiled to B cells, the chain's outputs from K3, a tangent of the
    cores' pattern: every output's tangent against the plain version's in
    float64 (1e-10 of its scale), in float32 as close to the float64
    tangent as the plain float32 version (4× plus 1e-5); the plan's shared
    memory is the compiled source's."""
    _need_card()
    _, Dp, sizes, _ = main_path.newton_matrices()
    D = Dp.to("cuda").repeat(-(-B // Dp.shape[0]), 1, 1)[:B].contiguous()
    dD = D * torch.as_tensor(np.random.default_rng(5).standard_normal(D.shape), device="cuda")
    ref = kd.dchain_tangent_plain(D, dD, kd.dchain_plain(D, sizes), sizes)
    D32, dD32 = D.to(dtype), dD.to(dtype)
    n = D.shape[-1]
    assert kd.dchain_tangent_smem_compiled(n, sizes, dtype) == kd.tangent_smem_bytes(
        n, sizes, dtype)
    before = gk.LAUNCHES["dchain_tangent"]
    got = kd.dchain_tangent_hot(D32, dD32, kd.dchain_cuda(D32, sizes), sizes)
    assert gk.LAUNCHES["dchain_tangent"] == before + 1
    plain = kd.dchain_tangent_plain(D32, dD32, kd.dchain_plain(D32, sizes), sizes)
    for g, p_, r in zip(got, plain, ref):
        err = _scaled_err(g, r)
        if dtype == torch.float64:
            assert err <= 1e-10, err
        else:
            assert err <= 4 * _scaled_err(p_, r) + 1e-5, (err, _scaled_err(p_, r))


@pytest.mark.parametrize("route, needs", [(None, {"gj_tangent": (71,)}),
                                          (FULL_KERNEL_ROUTE,
                                           {"gj_tangent": (10, 30), "dchain_tangent": (71,)})],
                         ids=["default", "full_kernel"])
def test_sensitivities_on_card_match_cpu(route, needs):
    """∂V/∂D_sp at 100, 300 and 550 s of a 1C discharge from SOC 0.5 (the
    JAX package's tests/test_estimation.py:18) on the card in float64 equal
    the port's on the CPU within rtol 1e-8; the tangent kernels launch at
    their n on the route."""
    _need_card()
    kw = dict(I_crate=-1.0, SOC=0.5, route=route)
    t_eval = np.array([100.0, 300.0, 550.0])
    gk.reset_launch_counts()
    J, th0 = estimation.sensitivities(ptt.petlion(ptt.LCO), ["D_sp"], t_eval, **kw)
    for name, ns in needs.items():
        for n in ns:
            assert gk.LAUNCHES_BY_N[name].get(n, 0) > 0, (name, n, gk.LAUNCHES_BY_N)
    J_cpu, _ = estimation.sensitivities(ptt.petlion(ptt.LCO, device="cpu"), ["D_sp"],
                                        t_eval, **kw)
    np.testing.assert_allclose(J, J_cpu, rtol=1e-8)
