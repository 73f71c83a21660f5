"""Solution container, on the host, appended to across runs (counterpart of
the JAX package's ``solution.py``).

Saved quantities accumulate across chained runs; `results` holds one
RunResult per run (tspan, exit flag and reason, iteration counts, the rows
of the run) so that `sol[i]` and the exit-reason accessors act per run.
Arrays are host numpy: a run's buffers come off the device in one copy at
its end. The ``.npz`` checkpoint of `save`/`load` has the JAX package's
keys, so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .config import EXIT_REASONS, EXIT_FAILED


# display labels with units
STATE_NAMES = {
    "V": "Voltage [V]",
    "I": "Current [C-rate]",
    "P": "Power [W/m²]",
    "SOC": "State of charge [-]",
    "c_e": "Electrolyte conc. [mol/m³]",
    "c_s_avg": "Solid conc. [mol/m³]",
    "T": "Temperature [K]",
    "j": "Ionic flux [mol/(m²·s)]",
    "j_s": "Side-reaction flux [mol/(m²·s)]",
    "film": "SEI film thickness [m]",
    "SOH": "State of health [-]",
    "Q": "Solid conc. flux [mol/m⁴]",
    "Phi_e": "Electrolyte potential [V]",
    "Phi_s": "Solid potential [V]",
}


def exit_reason_string(flag: int) -> str:
    if flag == EXIT_FAILED:
        return "Solver failure"
    if flag == -1:
        return ""
    if 0 <= flag < len(EXIT_REASONS):
        return EXIT_REASONS[flag]
    return f"Unknown exit flag {flag}"


@dataclasses.dataclass
class RunResult:
    method: str
    input_repr: str
    tspan: tuple
    flag: int
    exit_reason: str
    n_steps: int
    n_rejected: int
    run_index: slice          # rows of the solution arrays for this run
    init_converged: bool = True
    # the output ring buffer (opts.max_save) overflowed during this run:
    # intermediate accepted points were overwritten and the recorded arrays
    # miss part of the trajectory tail (raise max_save to keep everything)
    truncated: bool = False


def reset_t(sol: "Solution") -> "Solution":
    """Shift the saved time axis so it starts at 0. In place; returns the
    solution."""
    if "t" in sol.arrays and len(sol.arrays["t"]):
        # plain float: np.float32 - float stays np.float32 under NumPy-2
        # promotion and would break the JSON metadata in save()
        t0 = float(sol.arrays["t"][0])
        sol.arrays["t"] = sol.arrays["t"] - t0
        for i, r in enumerate(sol.results):
            sol.results[i] = dataclasses.replace(
                r, tspan=(r.tspan[0] - t0, r.tspan[1] - t0))
    return sol


@dataclasses.dataclass
class Solution:
    arrays: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    results: List[RunResult] = dataclasses.field(default_factory=list)
    Y_final: Optional[np.ndarray] = None
    YP_final: Optional[np.ndarray] = None
    SOC_final: float = 0.0

    # -- container protocol --------------------------------------------------

    def __len__(self):
        return len(self.results)

    def __bool__(self):
        return len(self.results) > 0

    def __getattr__(self, name):
        arrays = object.__getattribute__(self, "arrays")
        if name in arrays:
            return arrays[name]
        raise AttributeError(name)

    def __getitem__(self, i) -> "Solution":
        """Per-run view: the arrays and result of run `i`."""
        res = self.results[i]
        sub = Solution(
            arrays={k: v[res.run_index] for k, v in self.arrays.items()},
            results=[dataclasses.replace(
                res, run_index=slice(0, res.run_index.stop - res.run_index.start))],
            Y_final=self.Y_final, YP_final=self.YP_final,
            SOC_final=self.SOC_final)
        return sub

    # -- appending -----------------------------------------------------------

    def append_run(self, host_bufs: Dict[str, np.ndarray], n_saved: int,
                   t_offset: float, result_meta: dict,
                   y_final, yp_final, soc_final):
        start = len(self.arrays.get("t", ()))
        missing = set(self.arrays) - set(host_bufs)
        if missing:
            raise ValueError(
                f"continuation run did not record outputs {sorted(missing)} "
                f"present in earlier runs; pass matching outputs=")
        for k, buf in host_bufs.items():
            seg = np.array(buf[:n_saved])
            if k == "t":
                seg = seg + t_offset
            if k in self.arrays:
                self.arrays[k] = np.concatenate([self.arrays[k], seg], axis=0)
            else:
                if start != 0:
                    raise ValueError(
                        f"output '{k}' not recorded in earlier runs; chained "
                        f"runs must request compatible outputs")
                self.arrays[k] = seg
        stop = start + n_saved
        rr = RunResult(run_index=slice(start, stop), **result_meta)
        self.results.append(rr)
        self.Y_final = np.array(y_final)
        self.YP_final = np.array(yp_final)
        self.SOC_final = float(soc_final)
        return self

    # -- accessors ---------------------------------------------------------------

    def final_exit_reason(self) -> str:
        assert self.results, "empty solution"
        return self.results[-1].exit_reason

    def exit_reasons(self) -> List[str]:
        return [r.exit_reason for r in self.results]

    # -- interpolation -----------------------------------------------------------

    def __call__(self, t_query, interp_bc: str = "interpolate"):
        """Re-interpolate saved outputs onto arbitrary times.

        The Y array uses cubic Hermite when YP was also saved (the solver's
        exact derivatives: locally 4th order, with no boundary-condition
        ambiguity); everything else uses a natural cubic spline (through the
        native C++ runtime when it is built, numpy otherwise).
        """
        t_query = np.atleast_1d(np.asarray(t_query, dtype=float))
        out = Solution(results=self.results, Y_final=self.Y_final,
                       YP_final=self.YP_final, SOC_final=self.SOC_final)
        if getattr(self, "_Y_final_int", None) is not None:
            out._Y_final_int = self._Y_final_int
        if getattr(self, "_outputs", None):
            out._outputs = self._outputs
        tspans = [ (self.t[r.run_index][0], self.t[r.run_index][-1])
                   for r in self.results ]

        def seg_of(tq):
            for i, (a, b) in enumerate(tspans):
                if a <= tq <= b:
                    return i
            return 0 if tq < tspans[0][0] else len(tspans) - 1

        seg_idx = np.array([seg_of(tq) for tq in t_query])
        from .utils.interp import hermite_interp, spline_interp
        have_yp = "Y" in self.arrays and "YP" in self.arrays
        for k, v in self.arrays.items():
            if k == "t":
                out.arrays[k] = t_query
                continue
            res = np.empty(t_query.shape + v.shape[1:], dtype=v.dtype)
            for i, r in enumerate(self.results):
                m = seg_idx == i
                if not m.any():
                    continue
                tt = self.t[r.run_index]
                vv = v[r.run_index]
                extrap = interp_bc == "extrapolate"
                if k == "Y" and have_yp and len(tt) > 1:
                    res[m] = hermite_interp(
                        tt, vv, self.arrays["YP"][r.run_index], t_query[m],
                        extrapolate=extrap)
                else:
                    res[m] = spline_interp(tt, vv, t_query[m],
                                           extrapolate=extrap)
            out.arrays[k] = res
        return out

    # -- checkpoint / resume -----------------------------------------------------

    def save(self, path: str):
        """Persist the solution (arrays, run metadata, final state) to an
        .npz checkpoint; `Solution.load` restores it and `simulate(...,
        sol=loaded)` resumes from the final state."""
        meta = [dict(method=r.method, input_repr=r.input_repr, tspan=r.tspan,
                     flag=r.flag, exit_reason=r.exit_reason,
                     n_steps=r.n_steps, n_rejected=r.n_rejected,
                     run_index=(r.run_index.start, r.run_index.stop),
                     init_converged=r.init_converged, truncated=r.truncated)
                for r in self.results]
        import json
        extra = {}
        y_int = getattr(self, "_Y_final_int", None)
        if y_int is not None:   # internal solver carry (T-offset convention)
            extra["Y_final_int"] = y_int
        np.savez_compressed(
            path,
            __meta__=json.dumps(meta),
            __outputs__=json.dumps(list(getattr(self, "_outputs", ()))),
            Y_final=self.Y_final, YP_final=self.YP_final,
            SOC_final=np.float64(self.SOC_final),
            **extra,
            **{f"arr_{k}": v for k, v in self.arrays.items()})

    @staticmethod
    def load(path: str) -> "Solution":
        import json
        z = np.load(path, allow_pickle=False)
        sol = Solution()
        for k in z.files:
            if k.startswith("arr_"):
                sol.arrays[k[4:]] = z[k]
        for m in json.loads(str(z["__meta__"])):
            rs = m.pop("run_index")
            sol.results.append(RunResult(run_index=slice(*rs), **m))
        sol.Y_final = z["Y_final"]
        sol.YP_final = z["YP_final"]
        if "Y_final_int" in z.files:
            sol._Y_final_int = z["Y_final_int"]
        sol.SOC_final = float(z["SOC_final"])
        sol._outputs = tuple(json.loads(str(z["__outputs__"])))
        return sol

    # -- plotting ----------------------------------------------------------------

    def plot(self, state: str = "V", ax=None, **kw):
        """Plot a saved output against time with unit labels (STATE_NAMES).
        Vector states plot one line per node."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if state not in self.arrays:
            raise KeyError(
                f"{state!r} was not recorded; outputs={list(self.arrays)}")
        if ax is None:
            _, ax = plt.subplots(figsize=(7, 4))
        t = self.t
        x, xlabel = (t, "Time [s]")
        if t[-1] >= 2 * 3600:
            x, xlabel = t / 3600.0, "Time [hr]"
        elif t[-1] >= 120:
            x, xlabel = t / 60.0, "Time [min]"
        y = self.arrays[state]
        ax.plot(x, y, **kw)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(STATE_NAMES.get(state, state))
        for r in self.results[:-1]:
            ax.axvline(x[min(r.run_index.stop - 1, len(x) - 1)],
                       color="0.8", lw=0.8)
        return ax

    # -- pretty printing ---------------------------------------------------------

    def __repr__(self):
        if not self.results:
            return "PETLION-TPU solution: (empty)"
        runs = " → ".join(r.method for r in self.results)
        t_end = self.arrays["t"][-1] if "t" in self.arrays else float("nan")
        lines = [
            "PETLION-TPU simulation",
            " --------",
            f" Runs:    {runs}",
            f" Time:    {t_end:.6g} s",
        ]
        for label, key, fmt in (("Current", "I", "{:.4g}C"),
                                ("Voltage", "V", "{:.4f} V"),
                                ("Power", "P", "{:.4f} W/m²"),
                                ("SOC", "SOC", "{:.4f}")):
            if key in self.arrays and len(self.arrays[key]):
                lines.append(f" {label}: " + fmt.format(self.arrays[key][-1]))
        lines.append(f" Exit:    {self.final_exit_reason()}")
        return "\n".join(lines)
