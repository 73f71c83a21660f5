"""State vector layout — static index map of the DAE unknowns
(counterpart of the JAX package's ``layout.py``).

The layout is a hashable, static object of index ranges into a flat
``(..., N_tot)`` state; every access is a basic slice of the last axis, so it
works unchanged on batch-first ``(B, N_tot)`` tensors.

Ordering contract (identical to the JAX package, so state vectors are
interchangeable): differential states first, then algebraic, with the scalar
current ``I`` last:

    differential: c_e(p,s,n), c_s_avg(particle_p,particle_n | p,n),
                  T(a,p,s,n,z)?, film(n)?, SOH()?, eps_s(p,n)?, Q(p,n)?
    algebraic:    j(p,n), Φ_e(p,s,n), Φ_s(p,n), j_s(n)?, I()

For the default LCO/Fickian/isothermal mesh this gives 301 DAEs: 30+200
differential, 20+30+20+1 algebraic.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, Tuple

import numpy as np

from .config import Discretizations, Numerics


@dataclasses.dataclass(frozen=True)
class StateEntry:
    start: int
    length: int
    var_type: str  # "differential" | "algebraic"
    # ((section_name, offset_within_state, length), ...)
    sections: Tuple[Tuple[str, int, int], ...]

    @property
    def stop(self) -> int:
        return self.start + self.length

    def sl(self, section: str | None = None) -> slice:
        if section is None:
            return slice(self.start, self.stop)
        for name, off, ln in self.sections:
            if name == section:
                return slice(self.start + off, self.start + off + ln)
        raise KeyError(section)


@dataclasses.dataclass(frozen=True)
class StateLayout:
    N: Discretizations
    temperature: bool
    solid_diffusion: str
    aging: str | None
    _entries: Tuple[Tuple[str, StateEntry], ...]
    N_diff: int
    N_alg: int
    N_tot: int
    half_cell: bool = False

    @staticmethod
    def build(N: Discretizations, numerics: Numerics) -> "StateLayout":
        fick = numerics.solid_diffusion == "Fickian"
        sei = numerics.aging == "SEI"
        hc = numerics.anode == "Li_metal"

        def secs(*pairs):
            # half-cell: anode sections are kept with length 0
            out, off = [], 0
            for name, ln in pairs:
                if name == "n" and hc:
                    ln = 0
                out.append((name, off, ln))
                off += ln
            return tuple(out), off

        decl = []  # (name, var_type, sections, length)
        s, ln = secs(("p", N.p), ("s", N.s), ("n", N.n))
        decl.append(("c_e", "differential", s, ln))
        if fick:
            s, ln = secs(("p", N.p * N.r_p), ("n", N.n * N.r_n))
        else:
            s, ln = secs(("p", N.p), ("n", N.n))
        decl.append(("c_s_avg", "differential", s, ln))
        if numerics.temperature:
            s, ln = secs(("a", N.a), ("p", N.p), ("s", N.s), ("n", N.n), ("z", N.z))
            decl.append(("T", "differential", s, ln))
        if sei:
            s, ln = secs(("n", N.n))
            decl.append(("film", "differential", s, ln))
            decl.append(("SOH", "differential", (), 1))
        if numerics.aging == "stress":
            s, ln = secs(("p", N.p), ("n", N.n))
            decl.append(("eps_s", "differential", s, ln))
        if numerics.solid_diffusion == "polynomial":
            s, ln = secs(("p", N.p), ("n", N.n))
            decl.append(("Q", "differential", s, ln))

        s, ln = secs(("p", N.p), ("n", N.n))
        decl.append(("j", "algebraic", s, ln))
        s, ln = secs(("p", N.p), ("s", N.s), ("n", N.n))
        decl.append(("Phi_e", "algebraic", s, ln))
        s, ln = secs(("p", N.p), ("n", N.n))
        decl.append(("Phi_s", "algebraic", s, ln))
        if sei:
            s, ln = secs(("n", N.n))
            decl.append(("j_s", "algebraic", s, ln))
        decl.append(("I", "algebraic", (), 1))

        entries, pos, n_diff = [], 0, 0
        for var_type in ("differential", "algebraic"):
            for name, vt, sections, length in decl:
                if vt != var_type:
                    continue
                entries.append((name, StateEntry(pos, length, vt, sections)))
                pos += length
                if vt == "differential":
                    n_diff += length

        return StateLayout(
            N=N,
            temperature=numerics.temperature,
            solid_diffusion=numerics.solid_diffusion,
            aging=numerics.aging,
            _entries=tuple(entries),
            N_diff=n_diff,
            N_alg=pos - n_diff,
            N_tot=pos,
            half_cell=hc,
        )

    # ---- access -----------------------------------------------------------

    @cached_property
    def entries(self) -> Dict[str, StateEntry]:
        return dict(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def sl(self, name: str, section: str | None = None) -> slice:
        return self.entries[name].sl(section)

    def get(self, y, name: str, section: str | None = None):
        """Slice state `name` (optionally one section) out of the last axis."""
        return y[..., self.sl(name, section)]

    def c_s_surf(self, y, electrode: str):
        """Surface concentrations as a strided basic slice (no index tensor,
        so it costs nothing on a device)."""
        s = self.sl("c_s_avg", electrode)
        if self.solid_diffusion == "Fickian":
            n_r = getattr(self.N, "r_" + electrode)
            return y[..., s.start + n_r - 1:s.stop:n_r]
        return y[..., s]

    def c_s_surface_slice(self, electrode: str) -> np.ndarray:
        """Global indices of one electrode's particle-surface
        concentrations: every r-th node for Fickian diffusion, all of the
        electrode's states for the averaged models."""
        s = self.sl("c_s_avg", electrode)
        if self.solid_diffusion == "Fickian":
            n_r = getattr(self.N, "r_" + electrode)
            n_el = (s.stop - s.start) // n_r   # 0 for the half-cell anode
            return np.arange(1, n_el + 1) * n_r - 1 + s.start
        return np.arange(s.start, s.stop)

    def V(self, y):
        """Cell voltage = Φ_s[first cathode CV] − Φ_s[last anode CV]."""
        ps = self.sl("Phi_s")
        if self.half_cell:
            return y[..., ps.start]
        return y[..., ps.start] - y[..., ps.stop - 1]

    def I(self, y):
        """Applied current in C-rate units (the scalar state)."""
        return y[..., self.sl("I").start]

    def eta_plating(self, y):
        """Plating overpotential at the separator-anode interface."""
        if self.half_cell:
            return -y[..., self.sl("Phi_e").stop - 1]
        return (y[..., self.sl("Phi_s", "n").start]
                - y[..., self.sl("Phi_e", "n").start])

    def soc_from_state(self, y, th):
        """SOC estimate from the mean anode stoichiometry, (B,) from
        (B, N_tot) states and (B, 1) θ. Half cell: from the cathode's (the
        foil has no state of charge)."""
        if self.half_cell:
            frac = (self.get(y, "c_s_avg", "p").mean(dim=-1)
                    / th["c_max_p"][..., 0])
            return ((frac - th["theta_min_p"][..., 0])
                    / (th["theta_max_p"][..., 0] - th["theta_min_p"][..., 0]))
        frac = self.get(y, "c_s_avg", "n").mean(dim=-1) / th["c_max_n"][..., 0]
        return ((frac - th["theta_min_n"][..., 0])
                / (th["theta_max_n"][..., 0] - th["theta_min_n"][..., 0]))
