"""Structured Newton-matrix factorization exploiting the P2D block sparsity
(counterpart of the JAX package's ``ops/structured.py``, multi-group path without
nested levels).

    J = [ A  B ]   A: block-diagonal groups — the cathode and anode particle
        [ C  D ]      blocks (N_r × N_r each) and the c_e block
                   D: the core (j, Φ_e, Φ_s, I): 71 × 71 on the default mesh

Block elimination: D' = D − Σ_g C_g A_g⁻¹ B_g; then D' is inverted by the
equilibrated Gauss-Jordan (the CUDA kernel on the card). B and C have only a
few nonzero columns/rows per block, so the Schur update is gathers and a
scatter-add with no dense (n_elim × n_core) intermediates.

Everything carries a leading cells axis. The static index metadata is built
once on the host (numpy) and moved to the run's device once
(`device_specs`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..layout import StateLayout
from ..solver import linsolve


class GroupSplit(NamedTuple):
    """Static multi-group elimination layout (host numpy)."""
    group_rows: tuple        # tuple of (n_part, r) global-index arrays
    i_core: np.ndarray       # remaining indices (original order)


def make_group_split(layout: StateLayout, pattern: np.ndarray) -> GroupSplit:
    """Choose elimination groups, validating block-diagonality against the
    detected sparsity pattern (a group that couples stays in the core)."""
    N = layout.N
    s = layout.sl("c_s_avg")
    i_cs = np.arange(s.start, s.stop)
    if layout.solid_diffusion == "Fickian":
        rp, rn = N.r_p, N.r_n
    else:
        rp = rn = 1
    candidates = [i_cs[: N.p * rp].reshape(N.p, rp)]
    i_cs_n = i_cs[N.p * rp:]
    if i_cs_n.size:
        candidates.append(i_cs_n.reshape(-1, rn))
    ce = layout.sl("c_e")
    candidates.append(np.arange(ce.start, ce.stop).reshape(1, -1))

    groups = []
    for g in candidates:
        flat = g.reshape(-1)
        block_ok = True
        for k in range(g.shape[0]):
            other_blocks = np.setdiff1d(flat, g[k])
            if pattern[np.ix_(g[k], other_blocks)].any() or \
               pattern[np.ix_(other_blocks, g[k])].any():
                block_ok = False
                break
        if not block_ok:
            continue
        ok = True
        for h in groups:
            hf = h.reshape(-1)
            if pattern[np.ix_(flat, hf)].any() or \
               pattern[np.ix_(hf, flat)].any():
                ok = False
                break
        if ok:
            groups.append(g)
    i_elim = (np.concatenate([g.reshape(-1) for g in groups])
              if groups else np.zeros(0, dtype=np.int64))
    i_core = np.setdiff1d(np.arange(layout.N_tot), i_elim)
    return GroupSplit(group_rows=tuple(groups), i_core=i_core)


class CouplingSpec(NamedTuple):
    """Static per-group coupling metadata (host numpy)."""
    rows: np.ndarray       # (n_part, r) global row/col indices of the blocks
    bcols: np.ndarray      # (n_part, m_b) global core-col indices (padded)
    bmask: np.ndarray      # (n_part, r, m_b) pattern mask for B entries
    crows: np.ndarray      # (n_part, m_c) global core-row indices (padded)
    cmask: np.ndarray      # (n_part, m_c, r) pattern mask for C entries
    bpos: np.ndarray       # (n_part, m_b) positions of bcols within i_core
    cpos: np.ndarray       # (n_part, m_c) positions of crows within i_core


def _group_coupling(pattern, rows2d, i2, pos_of):
    n_part, r = rows2d.shape
    bcols, crows = [], []
    for k in range(n_part):
        rk = rows2d[k]
        bc = np.nonzero(pattern[rk][:, i2].any(axis=0))[0]
        cr = np.nonzero(pattern[i2][:, rk].any(axis=1))[0]
        bcols.append(i2[bc])
        crows.append(i2[cr])
    m_b = max(1, max(len(b) for b in bcols))
    m_c = max(1, max(len(c) for c in crows))

    def pad(lst, m):
        out = np.zeros((n_part, m), dtype=np.int64)
        valid = np.zeros((n_part, m), dtype=bool)
        for k, v in enumerate(lst):
            if len(v):
                out[k, :len(v)] = v
                out[k, len(v):] = v[0]
                valid[k, :len(v)] = True
        return out, valid

    bcols_p, bvalid = pad(bcols, m_b)
    crows_p, cvalid = pad(crows, m_c)
    bmask = np.zeros((n_part, r, m_b))
    cmask = np.zeros((n_part, m_c, r))
    for k in range(n_part):
        # padded entries repeat a real index; their mask is zero so the
        # scatter-add adds nothing twice
        bmask[k] = pattern[np.ix_(rows2d[k], bcols_p[k])] * bvalid[k][None, :]
        cmask[k] = pattern[np.ix_(crows_p[k], rows2d[k])] * cvalid[k][:, None]
    return CouplingSpec(rows=rows2d, bcols=bcols_p, bmask=bmask,
                        crows=crows_p, cmask=cmask,
                        bpos=pos_of[bcols_p], cpos=pos_of[crows_p])


def make_sparse_specs(colored, split: GroupSplit, layout: StateLayout = None,
                      nested_families=()):
    """Static specs for the multi-group Schur factorization: per-group
    coupling and the core submatrix spec. Nested in-core levels are not
    ported; asking for them raises."""
    if nested_families:
        raise NotImplementedError(
            f"nested in-core elimination levels {tuple(nested_families)}")
    i2 = split.i_core
    pattern = colored.pattern
    pos_of = np.zeros(colored.n, dtype=np.int64)
    pos_of[i2] = np.arange(len(i2))
    cspecs = tuple(_group_coupling(pattern, g, i2, pos_of)
                   for g in split.group_rows)
    spec_D = colored.submatrix_spec(i2, i2)
    return (cspecs, spec_D, (), None)


class GroupTensors(NamedTuple):
    """One group's coupling metadata as tensors on the run's device."""
    rows: torch.Tensor        # (n_part, r)
    rows_flat: torch.Tensor   # (n_part·r,)
    colc: torch.Tensor        # (n_part, r) colors of the block columns
    maskA: torch.Tensor       # (n_part, r, r)
    b_colors: torch.Tensor    # (n_part, m_b) colors of the B columns
    bmask: torch.Tensor       # (n_part, r, m_b)
    crows: torch.Tensor       # (n_part, m_c)
    cmask: torch.Tensor       # (n_part, m_c, r)
    c_is_last: torch.Tensor   # (n_part, m_c) rows that are the control row
    bpos: torch.Tensor        # (n_part, m_b)
    cpos: torch.Tensor        # (n_part, m_c)


class DeviceSpecs(NamedTuple):
    groups: tuple             # GroupTensors per group
    spec_D: tuple             # core submatrix spec, tensors
    i_core: torch.Tensor


def device_specs(colored, specs, split: GroupSplit, device, dtype) -> DeviceSpecs:
    cspecs, spec_D, _, _ = specs

    def lt(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def ft(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    groups = []
    for cs in cspecs:
        rows = cs.rows
        groups.append(GroupTensors(
            rows=lt(rows), rows_flat=lt(rows.reshape(-1)),
            colc=lt(colored.colors[rows]),
            maskA=ft(colored.pattern[rows[:, :, None], rows[:, None, :]]),
            b_colors=lt(colored.colors[cs.bcols]), bmask=ft(cs.bmask),
            crows=lt(cs.crows), cmask=ft(cs.cmask),
            c_is_last=torch.as_tensor(cs.crows == colored.n - 1, device=device),
            bpos=lt(cs.bpos), cpos=lt(cs.cpos)))
    r, c, cc, mask, last_pos = spec_D
    return DeviceSpecs(groups=tuple(groups),
                       spec_D=(lt(r), lt(c), lt(cc), ft(mask), last_pos),
                       i_core=lt(split.i_core))


class SparseSchur(NamedTuple):
    """Per-group (inv, AinvB, C) triples + the equilibrated core inverse,
    each with a leading cells axis."""
    groups: tuple
    core_inv: tuple


def _extract_A(JS, g: GroupTensors):
    # A[b, k, a, c] = J[rows[k,a], rows[k,c]] = JS[b, color[rows[k,c]], rows[k,a]]
    return JS[:, g.colc[:, None, :], g.rows[:, :, None]] * g.maskA


def _extract_B(JS, g: GroupTensors):
    # B[b, k, a, c] = J[rows[k,a], bcols[k,c]]
    return JS[:, g.b_colors[:, None, :], g.rows[:, :, None]] * g.bmask


def _extract_C(JS, last_row, g: GroupTensors):
    # C[b, k, i, a] = J[crows[k,i], rows[k,a]]; the control row is exact
    M = JS[:, g.colc[:, None, :], g.crows[:, :, None]] * g.cmask
    lr = last_row[:, g.rows][:, :, None, :]              # (B, n_part, 1, r)
    return torch.where(g.c_is_last[:, :, None], lr * g.cmask, M)


def sparse_schur_factor(JS, last_row, colored, dspecs: DeviceSpecs):
    B = JS.shape[0]
    bidx = torch.arange(B, device=JS.device)[:, None, None, None]
    D = colored.submatrix(JS, last_row, dspecs.spec_D)
    per_group = []
    for g in dspecs.groups:
        A = _extract_A(JS, g)                            # (B, n_part, r, r)
        # equilibrate, invert pivot-free (c0·I minus a diffusion operator:
        # diagonally dominant), then fold the scalings back:
        #   A⁻¹ = diag(1/col) · inv(As) · diag(1/row)
        colA = torch.clamp_min(A.abs().amax(dim=-2), 1e-30)
        rowA = torch.clamp_min((A / colA[..., None, :]).abs().amax(dim=-1),
                               1e-30)
        inv_s = linsolve.gj_inverse(A / colA[..., None, :] / rowA[..., :, None])
        inv = inv_s / colA[..., :, None] / rowA[..., None, :]
        Bm = _extract_B(JS, g)                           # (B, n_part, r, m_b)
        Cm = _extract_C(JS, last_row, g)                 # (B, n_part, m_c, r)
        AinvB = torch.matmul(inv, Bm)
        S = torch.matmul(Cm, AinvB)                      # (B, n_part, m_c, m_b)
        D = D.index_put((bidx, g.cpos[None, :, :, None], g.bpos[None, :, None, :]),
                        -S, accumulate=True)
        per_group.append((inv, AinvB, Cm))
    core_inv = linsolve.equilibrated_inv_factor(D)
    return SparseSchur(groups=tuple(per_group), core_inv=core_inv)


def sparse_schur_solve(fac: SparseSchur, b, dspecs: DeviceSpecs):
    B = b.shape[0]
    bidx = torch.arange(B, device=b.device)[:, None, None]
    rhs2 = b[:, dspecs.i_core]
    zs = []
    for (inv, AinvB, C), g in zip(fac.groups, dspecs.groups):
        n_part, r = g.rows.shape
        b1 = b[:, g.rows_flat].reshape(B, n_part, r, 1)
        z = torch.matmul(inv, b1)                        # (B, n_part, r, 1)
        cz = torch.matmul(C, z)[..., 0]                  # (B, n_part, m_c)
        rhs2 = rhs2.index_put((bidx, g.cpos[None]), -cz, accumulate=True)
        zs.append(z)
    x2 = linsolve.equilibrated_inv_solve(fac.core_inv, rhs2)
    x = torch.zeros_like(b)
    x[:, dspecs.i_core] = x2
    for (inv, AinvB, C), g, z in zip(fac.groups, dspecs.groups, zs):
        x2b = x2[:, g.bpos][..., None]                   # (B, n_part, m_b, 1)
        x1 = z - torch.matmul(AinvB, x2b)
        x[:, g.rows_flat] = x1.reshape(B, -1)
    return x
