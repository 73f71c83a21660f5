"""Structured Newton-matrix factorization exploiting the P2D block sparsity
(counterpart of the JAX package's ``ops/structured.py``, multi-group path with
its nested in-core levels).

    J = [ A  B ]   A: block-diagonal groups — the cathode and anode particle
        [ C  D ]      blocks (N_r × N_r each) and the c_e block
                   D: the core (j, Φ_e, Φ_s, I): 71 × 71 on the default mesh

Block elimination: D' = D − Σ_g C_g A_g⁻¹ B_g. B and C have only a few
nonzero columns/rows per block, so the Schur update is gathers and a
scatter-add with no dense (n_elim × n_core) intermediates. Then, when the
plan names nested families (j, then Φ_s: core 71 → 51 → 31), each is
eliminated from the dense core in turn, and what is left is inverted by the
equilibrated Gauss-Jordan (K1 on the card).

The route picks where the linear algebra runs: with ``blocks`` the group
inverses go to K2 (``ops/gj_blocks.py``); with ``dchain`` the whole nested
chain and the core inverse go to K3 (``ops/dchain.py``) on the core permuted
so that each level is a leading block, and the factorization is a
``SparseSchurP`` solved in permuted coordinates. A CPU tensor takes each
kernel's plain version through the same data flow.

Everything carries a leading cells axis. The static index metadata is built
once on the host (numpy) and moved to the run's device once
(`device_specs`).

The particle Schur complement of a dense Newton matrix
(`schur_factor_from_dense`, `make_schur_solver`: the JAX package's
``run_once(linear_solver=...)`` route) eliminates only the particle blocks,
in plain Gauss-Jordan, and inverts the rest, a 101-state core on the
default LCO mesh, by the equilibrated Gauss-Jordan (K1 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..layout import StateLayout
from ..solver import linsolve
from .dchain import dchain_hot, inv_equil
from .gj_blocks import gj_blocks_hot


@dataclasses.dataclass(frozen=True, eq=False)
class ParticleSplit:
    """Static index split of the state vector (host numpy), and its index
    tensors on each device it has been used on."""
    i_cs: np.ndarray        # indices of the c_s_avg states
    i_core: np.ndarray      # all other indices (original order)
    n_part_p: int
    n_part_n: int
    r_p: int
    r_n: int
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def index(self, device):
        """(i_cs, i_core, particle block indices p, n) as tensors on
        `device`, made once per device."""
        if device not in self._dev:
            def blocks(offsets, r):
                return torch.as_tensor(np.asarray(offsets)[:, None] + np.arange(r)[None, :],
                                       device=device)
            np_, nn_, rp, rn = self.n_part_p, self.n_part_n, self.r_p, self.r_n
            self._dev[device] = (
                torch.as_tensor(self.i_cs, device=device),
                torch.as_tensor(self.i_core, device=device),
                blocks(np.arange(np_) * rp, rp), blocks(np_ * rp + np.arange(nn_) * rn, rn))
        return self._dev[device]


def make_split(layout: StateLayout) -> ParticleSplit:
    s = layout.sl("c_s_avg")
    i_cs = np.arange(s.start, s.stop)
    i_core = np.concatenate([np.arange(0, s.start), np.arange(s.stop, layout.N_tot)])
    N = layout.N
    n_n = 0 if layout.half_cell else N.n   # foil anode: no particle blocks
    if layout.solid_diffusion == "Fickian":
        return ParticleSplit(i_cs, i_core, N.p, n_n, N.r_p, N.r_n)
    # quadratic/polynomial: each "particle block" is a 1x1 scalar
    return ParticleSplit(i_cs, i_core, N.p, n_n, 1, 1)


class SchurLU(NamedTuple):
    """The particle Schur factorization, each field with a leading cells
    axis; every solve with it is matmuls only."""
    inv_p: torch.Tensor      # (B, n_part_p, r_p, r_p) particle-block inverses
    inv_n: torch.Tensor      # (B, n_part_n, r_n, r_n)
    AinvB: torch.Tensor      # (B, n_cs, n_core)
    C: torch.Tensor          # (B, n_core, n_cs)
    core_inv: tuple          # equilibrated inverse of the Schur complement


def _apply_blocks(inv_p, inv_n, split: ParticleSplit, b):
    """A⁻¹ b by block matmuls; b (B, n_cs) or (B, n_cs, m)."""
    np_, nn_, rp, rn = split.n_part_p, split.n_part_n, split.r_p, split.r_n
    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    B, m = b.shape[0], b.shape[-1]
    xp = torch.matmul(inv_p, b[:, :np_ * rp].reshape(B, np_, rp, m))
    xn = torch.matmul(inv_n, b[:, np_ * rp:].reshape(B, nn_, rn, m))
    x = torch.cat([xp.reshape(B, np_ * rp, m), xn.reshape(B, nn_ * rn, m)], dim=1)
    return x[..., 0] if squeeze else x


def _gather_blocks(A, idx):
    """The diagonal blocks A[:, idx[k], idx[k]], (B, n_part, r, r)."""
    return A[:, idx[:, :, None], idx[:, None, :]]


def particle_schur_complement(J, split: ParticleSplit):
    """(inv_p, inv_n, A⁻¹B, C, D − C A⁻¹B) of dense Newton matrices
    (B, N, N): the particle blocks eliminated, the core left to invert."""
    i1, i2, idx_p, idx_n = split.index(J.device)
    A = _sub(J, i1, i1)
    # particle blocks are diagonally dominant (c0·I minus a scaled diffusion
    # operator) and scaled within: a plain pivot-free inverse, as JAX's
    inv_p = linsolve.gj_inverse(_gather_blocks(A, idx_p))
    inv_n = linsolve.gj_inverse(_gather_blocks(A, idx_n))
    AinvB = _apply_blocks(inv_p, inv_n, split, _sub(J, i1, i2))
    C = _sub(J, i2, i1)
    return inv_p, inv_n, AinvB, C, _sub(J, i2, i2) - torch.matmul(C, AinvB)


def schur_factor_from_dense(J, split: ParticleSplit) -> SchurLU:
    """Factor dense Newton matrices (B, N, N) by the particle Schur
    complement; the core through the equilibrated Gauss-Jordan (K1 on the
    card)."""
    inv_p, inv_n, AinvB, C, core = particle_schur_complement(J, split)
    return SchurLU(inv_p=inv_p, inv_n=inv_n, AinvB=AinvB, C=C,
                   core_inv=linsolve.equilibrated_inv_factor(core))


def schur_solve(fac: SchurLU, b, split: ParticleSplit):
    i1, i2, _, _ = split.index(b.device)
    z1 = _apply_blocks(fac.inv_p, fac.inv_n, split, b[:, i1])
    rhs2 = b[:, i2] - _mv(fac.C, z1)
    x2 = linsolve.equilibrated_inv_solve(fac.core_inv, rhs2)
    x = torch.zeros_like(b)
    x[:, i1] = z1 - _mv(fac.AinvB, x2)
    x[:, i2] = x2
    return x


def make_schur_solver(layout: StateLayout):
    """(factor, solve) pair for ``run_once(linear_solver=...)``."""
    split = make_split(layout)

    def factor(J):
        return schur_factor_from_dense(J, split)

    def solve(fac, b):
        return schur_solve(fac, b, split)

    return factor, solve


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


def make_nested_specs(layout: StateLayout, i_core: np.ndarray,
                      families=("j", "Phi_s")) -> tuple:
    """Static per-level (e_pos, r_pos) position arrays into the shrinking
    core vector, one level per eliminated family. The control row (last
    core position) always stays in the final core."""
    cur = np.asarray(i_core)
    specs = []
    for fam in families:
        if fam not in layout:
            continue
        s = layout.sl(fam)
        mask = np.isin(cur, np.arange(s.start, s.stop))
        if not mask.any() or mask.all():
            continue
        e_pos = np.nonzero(mask)[0]
        r_pos = np.nonzero(~mask)[0]
        specs.append((e_pos, r_pos))
        cur = cur[r_pos]
    return tuple(specs)


def make_sparse_specs(colored, split: GroupSplit, layout: StateLayout = None,
                      nested_families=("j", "Phi_s")):
    """Static specs for the multi-group Schur factorization: per-group
    coupling, the core submatrix spec, the nested in-core levels (none
    without a layout) and `pinfo` = (perm, sizes), the core permutation that
    makes each level a leading block (None without levels)."""
    i2 = split.i_core
    pattern = colored.pattern
    pos_of = np.zeros(colored.n, dtype=np.int64)
    pos_of[i2] = np.arange(len(i2))
    cspecs = tuple(_group_coupling(pattern, g, i2, pos_of)
                   for g in split.group_rows)
    spec_D = colored.submatrix_spec(i2, i2)
    nested = (make_nested_specs(layout, i2, nested_families)
              if layout is not None else ())
    pinfo = None
    if nested:
        cur = np.arange(len(i2))
        order, sizes = [], []
        for e_pos, r_pos in nested:
            order.append(cur[e_pos])
            sizes.append(len(e_pos))
            cur = cur[r_pos]
        order.append(cur)
        pinfo = (np.concatenate(order), tuple(sizes))
    return (cspecs, spec_D, nested, pinfo)


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
    levels: tuple             # per nested level (e_pos, r_pos)
    perm: torch.Tensor        # core permutation of pinfo (None without levels)
    sizes: tuple              # level sizes of pinfo


def device_specs(colored, specs, split: GroupSplit, device, dtype) -> DeviceSpecs:
    cspecs, spec_D, nested, pinfo = specs

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
    perm, sizes = pinfo if pinfo is not None else (None, ())
    return DeviceSpecs(groups=tuple(groups),
                       spec_D=(lt(r), lt(c), lt(cc), ft(mask), last_pos),
                       i_core=lt(split.i_core),
                       levels=tuple((lt(e), lt(r_)) for e, r_ in nested),
                       perm=None if perm is None else lt(perm), sizes=sizes)


class SparseSchur(NamedTuple):
    """Per-group (inv, AinvB, C) triples, per nested level (invA, AinvB, C)
    triples and the equilibrated core inverse, each with a leading cells
    axis."""
    groups: tuple
    core_inv: tuple
    levels: tuple = ()


class SparseSchurP(NamedTuple):
    """The fused-chain variant, in PERMUTED core coordinates (the levels are
    leading blocks; the plan's `perm` holds the permutation): per-group
    triples as in SparseSchur, per-level (invA, AinvB, C) from the chain,
    and the FOLDED core inverse (scalings multiplied back), so a solve with
    it is one matvec."""
    groups: tuple
    core_inv: torch.Tensor
    levels: tuple = ()


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


def _sub(D, rows, cols):
    return D[:, rows[:, None], cols[None, :]]


def eliminate_groups(JS, last_row, colored, dspecs: DeviceSpecs, *,
                     blocks: bool = False):
    """The level-1 group eliminations: (per-group (inv, AinvB, C) triples,
    the Schur core D = J22 − Σ_g C_g A_g⁻¹ B_g). `blocks` sends the group
    inverses (n ≥ 10) to K2."""
    B = JS.shape[0]
    bidx = torch.arange(B, device=JS.device)[:, None, None, None]
    D = colored.submatrix(JS, last_row, dspecs.spec_D)
    per_group = []
    for g in dspecs.groups:
        A = _extract_A(JS, g)                            # (B, n_part, r, r)
        # equilibrated pivot-free inverse (c0·I minus a diffusion operator:
        # diagonally dominant); K2 takes the blocks as the JAX package's
        # _gj_inverse_routed(min_n=10) does
        inv = inv_equil(A, gj_blocks_hot if blocks and A.shape[-1] >= 10
                        else linsolve.gj_inverse)
        Bm = _extract_B(JS, g)                           # (B, n_part, r, m_b)
        Cm = _extract_C(JS, last_row, g)                 # (B, n_part, m_c, r)
        AinvB = torch.matmul(inv, Bm)
        S = torch.matmul(Cm, AinvB)                      # (B, n_part, m_c, m_b)
        D = D.index_put((bidx, g.cpos[None, :, :, None], g.bpos[None, :, None, :]),
                        -S, accumulate=True)
        per_group.append((inv, AinvB, Cm))
    return tuple(per_group), D


def permuted_core(D, dspecs: DeviceSpecs):
    """The core with the rows and columns of the plan's permutation, so that
    each nested level is a leading block (K3's input)."""
    return _sub(D, dspecs.perm, dspecs.perm)


def sparse_schur_factor(JS, last_row, colored, dspecs: DeviceSpecs, *,
                        blocks: bool = False, dchain: bool = False):
    """Factor the Newton matrix given by its colored sweeps. `blocks` sends
    the group inverses (n ≥ 10) to K2; `dchain` sends the nested chain and
    the core inverse to K3 (when the plan has levels) and returns a
    SparseSchurP."""
    per_group, D = eliminate_groups(JS, last_row, colored, dspecs,
                                    blocks=blocks)
    if dchain and dspecs.perm is not None:
        # the whole chain in one kernel, on the core permuted so that each
        # level is a leading block
        outs = dchain_hot(permuted_core(D, dspecs), dspecs.sizes)
        levels = tuple(outs[3 * i:3 * i + 3] for i in range(len(dspecs.sizes)))
        return SparseSchurP(groups=per_group, core_inv=outs[-1], levels=levels)
    levels = []
    for e_pos, r_pos in dspecs.levels:
        # with blocks, a level of 17 or more goes to K1, as the JAX package
        # routes it (_gj_inverse_routed(min_n=17))
        A = _sub(D, e_pos, e_pos)
        invA = inv_equil(A, linsolve.gj_inverse_hot if blocks and A.shape[-1] >= 17
                         else linsolve.gj_inverse)
        AinvB = torch.matmul(invA, _sub(D, e_pos, r_pos))
        Cm = _sub(D, r_pos, e_pos)
        D = _sub(D, r_pos, r_pos) - torch.matmul(Cm, AinvB)
        levels.append((invA, AinvB, Cm))
    core_inv = linsolve.equilibrated_inv_factor(D)
    return SparseSchur(groups=per_group, core_inv=core_inv, levels=tuple(levels))


def _mv(M, v):
    return torch.matmul(M, v[..., None])[..., 0]


def sparse_schur_solve(fac, b, dspecs: DeviceSpecs):
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
    zl = []
    if isinstance(fac, SparseSchurP):
        # permuted coordinates: each level is a leading block
        r2 = rhs2[:, dspecs.perm]
        for (invA, AinvB, Cm), nk in zip(fac.levels, dspecs.sizes):
            z = _mv(invA, r2[:, :nk])
            r2 = r2[:, nk:] - _mv(Cm, z)
            zl.append(z)
        x2 = _mv(fac.core_inv, r2)
        for (invA, AinvB, Cm), z in zip(reversed(fac.levels), reversed(zl)):
            x2 = torch.cat([z - _mv(AinvB, x2), x2], dim=-1)
        xu = torch.empty_like(x2)
        xu[:, dspecs.perm] = x2                          # unpermute
        x2 = xu
    else:
        for (invA, AinvB, Cm), (e_pos, r_pos) in zip(fac.levels, dspecs.levels):
            z = _mv(invA, rhs2[:, e_pos])
            rhs2 = rhs2[:, r_pos] - _mv(Cm, z)
            zl.append(z)
        x2 = linsolve.equilibrated_inv_solve(fac.core_inv, rhs2)
        for (invA, AinvB, Cm), (e_pos, r_pos), z in zip(
                reversed(fac.levels), reversed(dspecs.levels), reversed(zl)):
            xf = x2.new_empty((B, len(e_pos) + len(r_pos)))
            xf[:, r_pos] = x2
            xf[:, e_pos] = z - _mv(AinvB, x2)
            x2 = xf
    x = torch.zeros_like(b)
    x[:, dspecs.i_core] = x2
    for (inv, AinvB, C), g, z in zip(fac.groups, dspecs.groups, zs):
        x2b = x2[:, g.bpos][..., None]                   # (B, n_part, m_b, 1)
        x1 = z - torch.matmul(AinvB, x2b)
        x[:, g.rows_flat] = x1.reshape(B, -1)
    return x
