"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain versions, and short main-path runs on the card. They skip where
torch.cuda.is_available() is False. This file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch.ops import dchain as kd
from petlion_tpu_torch.ops import gj_blocks as kb
from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.ops.plan import FULL_KERNEL_ROUTE
from petlion_tpu_torch.solver import linsolve

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.parametrize("dtype, n, tol",
                         [(torch.float32, n, 2e-4) for n in (17, 31, 71, 128, 169)]
                         + [(torch.float64, n, 1e-10) for n in (71, 120)])
def test_kernel_matches_plain_on_card(dtype, n, tol):
    """K1 against its mirror (the same order of operations) and the plain
    blocked version, at ragged batches, each tile shape of the kernel."""
    _need_card()
    for B in (5, 1024):
        rng = np.random.default_rng(B + n)
        A = rng.standard_normal((B, n, n)) + 20.0 * np.eye(n)
        A = torch.as_tensor(A, dtype=dtype, device="cuda")
        A = linsolve._equilibrate(A)[0].contiguous()
        before = gk.LAUNCHES["gj_inverse"]
        got = gk.gj_inverse_hot(A)
        assert gk.LAUNCHES["gj_inverse"] == before + 1
        assert float((got - gk.gj_inverse_inplace(A)).abs().max()) <= tol
        want = gk.gj_inverse_blocked(A, bs=gk._best_bs(n))
        assert float((got - want).abs().max()) <= tol
    with pytest.raises(ValueError):
        gk.gj_inverse_cuda(torch.zeros(2, 71, 71, device="cuda").transpose(1, 2))
    with pytest.raises(ValueError):
        gk.gj_inverse_cuda(torch.zeros(2, gk.MAX_N[dtype] + 1, gk.MAX_N[dtype] + 1,
                                       dtype=dtype, device="cuda"))


@pytest.mark.parametrize("n", [1, 7, 8, 10, 16, 17, 30, 32])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-4),
                                        (torch.float64, 1e-10)])
def test_gj_blocks_matches_plain_on_card(dtype, tol, n):
    """K2 against its mirror (the same order of operations) and the plain
    version, at ragged stacks and a main-path-sized one, at each lane group
    of the kernel (n = 10 and 30 exact, the others padded to 8, 16, 32)."""
    _need_card()
    for M in (5, 10240 if n == 10 else 1024):
        rng = np.random.default_rng(M + n)
        A = rng.standard_normal((M, n, n)) + 15.0 * np.eye(n)
        A = torch.as_tensor(A, dtype=dtype, device="cuda")
        A = linsolve._equilibrate(A)[0].contiguous()
        before = gk.LAUNCHES["gj_blocks"]
        got = kb.gj_blocks_hot(A)
        assert gk.LAUNCHES["gj_blocks"] == before + 1
        assert float((got - kb.gj_blocks_mirror(A)).abs().max()) <= tol
        assert float((got - kb.gj_blocks_plain(A)).abs().max()) <= tol
    with pytest.raises(ValueError):
        kb.gj_blocks_cuda(torch.zeros(2, 33, 33, device="cuda"))


@pytest.mark.parametrize("B, n, sizes", [(1024, 71, (20, 20)), (5, 71, (20, 20)),
                                         (3, 40, (7,)), (2, 25, ()),
                                         (64, 101, (35, 35))])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-11)])
def test_dchain_matches_plain_on_card(dtype, tol, B, n, sizes):
    """Diagonally dominant cores (well conditioned, unlike the real Φ_s
    level): every output within `tol` of its scale, against the plain chain
    and against its mirror; (35, 35) takes the 16×16 tile grid."""
    _need_card()
    rng = np.random.default_rng(B + n)
    D = (0.3 * rng.standard_normal((B, n, n))
         + 15.0 * np.eye(n) * rng.uniform(0.1, 10.0, (B, 1, n)))
    D = torch.as_tensor(D, dtype=dtype, device="cuda")
    before = gk.LAUNCHES["dchain"]
    got = kd.dchain_hot(D, sizes)
    assert gk.LAUNCHES["dchain"] == before + 1
    for a, b, c in zip(got, kd.dchain_plain(D, sizes), kd.dchain_mirror(D, sizes)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
        assert float((a - c).abs().max()) <= tol * float(c.abs().max())


def test_float32_cuda_run_refused_under_tf32():
    """A float32 run on the card raises while matmul TF32 is on, and the
    port leaves the flag as the caller set it."""
    _need_card()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            ptt.petlion(ptt.LCO, device="cuda", dtype=torch.float32)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        ptt.petlion(ptt.LCO, device="cuda", dtype=torch.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_main_path_on_card_matches_cpu():
    """Eight cells in float64 on the card go through the kernel and give
    the CPU run's exit times and voltages (1e-9)."""
    _need_card()
    rng = np.random.default_rng(5)
    tb = {"D_sp": 1e-14 * (1 + 0.05 * rng.standard_normal(8)),
          "k_n": 5.031e-11 * (1 + 0.05 * rng.standard_normal(8))}
    out = {}
    for dev in ("cuda", "cpu"):
        p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64)
        gk.reset_launch_counts()
        res = ptt.batch_simulate(p, 3.9e3, I=-1.0, SOC=1.0, theta_batch=tb,
                                 outputs=("t", "V"), max_save=4)
        out[dev] = (res, gk.LAUNCHES["gj_inverse"], p)
    (rg, launches, p), (rc, cpu_launches, _) = out["cuda"], out["cpu"]
    assert launches > 0 and cpu_launches == 0
    np.testing.assert_array_equal(rg.flag.cpu().numpy(), rc.flag.numpy())
    np.testing.assert_allclose(rg.t_final.cpu().numpy(), rc.t_final.numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(p.layout.V(rg.y_final).cpu().numpy(),
                               p.layout.V(rc.y_final).numpy(), rtol=1e-9)


def test_full_kernel_route_on_card_matches_cpu():
    """Eight cells in float64 on the full-kernel route (path 2): the card
    launches K1, K2 and K3, the CPU none, and both give the same flags, exit
    times and voltages (1e-9)."""
    _need_card()
    rng = np.random.default_rng(6)
    tb = {"D_sp": 1e-14 * (1 + 0.05 * rng.standard_normal(8)),
          "k_n": 5.031e-11 * (1 + 0.05 * rng.standard_normal(8))}
    out = {}
    for dev in ("cuda", "cpu"):
        p = ptt.petlion(ptt.LCO, device=dev, dtype=torch.float64)
        gk.reset_launch_counts()
        res = ptt.batch_simulate(p, 3.9e3, I=-1.0, SOC=1.0, theta_batch=tb,
                                 outputs=("t", "V"), max_save=4,
                                 route=FULL_KERNEL_ROUTE)
        out[dev] = (res, dict(gk.LAUNCHES), p)
    (rg, launches, p), (rc, cpu_launches, _) = out["cuda"], out["cpu"]
    assert all(launches[k] > 0 for k in ("gj_inverse", "gj_blocks", "dchain"))
    assert launches["gj_blocks"] == 3 * launches["dchain"]
    assert not any(cpu_launches.values())
    np.testing.assert_array_equal(rg.flag.cpu().numpy(), rc.flag.numpy())
    np.testing.assert_allclose(rg.t_final.cpu().numpy(), rc.t_final.numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(p.layout.V(rg.y_final).cpu().numpy(),
                               p.layout.V(rc.y_final).numpy(), rtol=1e-9)
