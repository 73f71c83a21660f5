"""Top-level user API: the model factory and single-cell runs (counterpart
of the JAX package's ``sim.py``).

    p   = petlion(LCO)                          # on CUDA, float64
    p   = petlion(LCO, device="cpu")            # the CPU, as the tests run
    sol = simulate(p, I=-1, SOC=1)              # one cell → Solution
    sol = simulate_cont(sol, p, 600.0, I="rest")
    res = batch_simulate(p, 3.9e3, I=-1, SOC=1, theta_batch={...})

`simulate` runs one cell on the batch-first runner at B = 1. Every option
and stop bound is a per-call keyword, and θ may be edited on `p.theta`
between calls. Entry points run on ``cuda`` unless the caller passes another
device; asking for CUDA where there is none raises. Nothing falls back to
the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from .chemistry import LCO
from .config import Bounds, Discretizations, Numerics, SimOptions
from .constants import FARADAY
from .layout import StateLayout
from .ops.plan import get_plan
from .physics.initial_guess import initial_guess
from .physics.residuals import ModelConfig, active_material, calc_I1C
from .solution import Solution, exit_reason_string
from .solver import control as ctrl
from .solver import events
from .solver.run import absolute_T, run_once

_OPT_KEYS = ("outputs", "abstol", "abstol_T", "reltol", "abstol_init",
             "reltol_init", "maxiters", "check_bounds", "reinit", "verbose",
             "interp_final", "interp_bc", "max_order", "max_save",
             "newton_maxiter", "init_maxiter", "dt0", "dtmax", "save_start",
             "stop_function", "jac_reuse", "step_control")
_METHOD_KEYS = ("I", "V", "P", "eta_p", "res", "dT",
                "dc_s_p_max", "dc_s_p_min", "dc_s_n_max", "dc_s_n_min",
                "dc_e_max", "dc_e_min", "T")


def resolve_device(device, dtype: torch.dtype) -> torch.device:
    """The run's device. CUDA must exist when asked for, and a float32 run
    there needs full-precision float32 products: it raises while TF32 is on
    for matmuls, as the elimination's products must not round to TF32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "a float32 run on CUDA needs torch.backends.cuda.matmul."
                "allow_tf32 = False (TF32 rounds the elimination's products)")
    return dev


@dataclasses.dataclass
class Model:
    """Parameters + static model structure. θ is a dict of 0-d tensors on
    the model's device and dtype."""
    theta: dict
    bounds: Bounds
    opts: SimOptions
    N: Discretizations
    numerics: Numerics
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype

    @property
    def layout(self) -> StateLayout:
        return self.cfg.layout

    @property
    def I1C(self) -> float:
        th = {k: v.reshape(1, 1) for k, v in self.theta.items()}
        return float(calc_I1C(th))

    def theta_floats(self) -> dict:
        return {k: float(v) for k, v in self.theta.items()}

    def __repr__(self):
        """Structured summary: electrodes and closures, options, the
        limiting electrode's capacity, the active bounds, node points (the
        JAX package's text)."""
        n, N, b = self.numerics, self.N, self.bounds
        fn = lambda f: getattr(f, "__name__", repr(f))  # noqa: E731

        th = self.theta_floats()
        eps_sp, eps_sn = active_material(th)
        q_p = eps_sp * th["l_p"] * th["c_max_p"] * (th["theta_min_p"] - th["theta_max_p"])
        q_n = eps_sn * th["l_n"] * th["c_max_n"] * (th["theta_max_n"] - th["theta_min_n"])
        q_min = (FARADAY / 3600.0) * min(q_p, q_n)
        lim = "cathode" if q_p <= q_n else "anode"
        cap_line = f"  Total capacity:  {q_min:.2f} Ah/m², {lim}-limited\n"

        def bound_line(title, lo, hi, unit=""):
            has_lo, has_hi = not math.isnan(lo), not math.isnan(hi)
            if not (has_lo or has_hi):
                return ""
            if has_lo and has_hi:
                rng = f"[{lo:g}{unit}, {hi:g}{unit}]"
            elif has_lo:
                rng = f"min {lo:g}{unit}"
            else:
                rng = f"max {hi:g}{unit}"
            return f"  {title + ':':<16} {rng}\n"

        nan = float("nan")
        L = self.cfg.layout
        lines = [
            "PETLION-TPU model:\n",
            f"  Cathode: {n.cathode}, {fn(n.rxn_p)}, & {fn(n.OCV_p)}\n",
            f"  Anode:   {n.anode}, {fn(n.rxn_n)}, & {fn(n.OCV_n)}\n",
            f"  System:  {fn(n.D_s_eff)}, {fn(n.rxn_rate)}, {fn(n.D_eff)}, "
            f"{fn(n.K_eff)}, & {fn(n.thermodynamic_factor)}\n",
            "  ---Options---\n",
            f"  Temperature:     {n.temperature}\n",
            f"  Solid diffusion: {n.solid_diffusion}"
            + (f", {n.Fickian_method}\n" if n.solid_diffusion == "Fickian"
               else "\n"),
            f"  Aging:           {n.aging}\n",
            cap_line,
            bound_line("Voltage", b.V_min, b.V_max, " V"),
            bound_line("SOC", b.SOC_min, b.SOC_max),
            bound_line("Current", b.I_min, b.I_max, "C"),
            (bound_line("Temperature", nan, b.T_max - 273.15, " °C")
             if n.temperature else ""),
            bound_line("Anode sat.", nan, b.c_s_n_max),
            "  ---Node Points---\n",
            (f"  Pos. tab:        {N.a}\n" if n.temperature else ""),
            f"  Pos. electrode:  {N.p}\n",
            (f"  Pos. particles:  {N.r_p}\n"
             if n.solid_diffusion == "Fickian" else ""),
            f"  Separator:       {N.s}\n",
            f"  Neg. electrode:  {N.n}\n",
            (f"  Neg. particles:  {N.r_n}\n"
             if n.solid_diffusion == "Fickian" else ""),
            (f"  Neg. tab:        {N.z}\n" if n.temperature else ""),
            f"  DAE system:      N_tot={L.N_tot} "
            f"(diff {L.N_diff}, alg {L.N_alg})",
        ]
        return "".join(lines)


# θ keys each optional physics variant requires
_REQUIRED_THETA = {
    "temperature": ("l_a", "l_z", "lam_a", "lam_p", "lam_s", "lam_n", "lam_z",
                    "rho_a", "rho_p", "rho_s", "rho_n", "rho_z",
                    "Cp_a", "Cp_p", "Cp_s", "Cp_n", "Cp_z",
                    "sigma_a", "sigma_z", "h_cell", "T_amb"),
    "SEI": ("R_SEI", "k_n_aging", "M_n", "rho_n", "i_0_jside", "Uref_s", "w"),
    "stress": ("E_p", "nu_p", "Omega_p", "sigma_critical_p",
               "E_n", "nu_n", "Omega_n", "sigma_critical_n",
               "m_LAM", "beta_LAM"),
}


def _check_errors_initial(theta: dict, numerics: Numerics):
    """A chemistry must define the θ its physics options need."""
    def missing_for(feature, keys):
        missing = sorted(k for k in keys if k not in theta)
        if missing:
            raise ValueError(
                f"chemistry '{numerics.cathode}/{numerics.anode}' does not "
                f"define the parameters required for {feature}: missing "
                f"θ keys {missing}")
    if numerics.temperature:
        missing_for("temperature=True (thermal model)",
                    _REQUIRED_THETA["temperature"])
    if numerics.aging == "SEI":
        missing_for("aging='SEI'", _REQUIRED_THETA["SEI"])
    if numerics.aging == "stress":
        missing_for("aging='stress' (stress-driven LAM)",
                    _REQUIRED_THETA["stress"])
    if numerics.anode == "Li_metal" and numerics.aging == "SEI":
        raise ValueError(
            "anode='Li_metal' (half-cell) does not support aging='SEI': "
            "the SEI model lives on the porous anode's particles")


def make_model(theta: dict, bounds: Bounds, opts: SimOptions,
               N: Discretizations, numerics: Numerics, *, device,
               dtype) -> Model:
    cfg = ModelConfig.build(N, numerics)
    dev = resolve_device(device, dtype)
    th = {k: torch.tensor(float(v), dtype=dtype, device=dev)
          for k, v in theta.items()}
    return Model(theta=th, bounds=bounds, opts=opts, N=N, numerics=numerics,
                 cfg=cfg, device=dev, dtype=dtype)


def default_dtype() -> torch.dtype:
    """The dtype of a model unless the caller names one: float64, as the JAX
    package's ``default_dtype()`` under ``jax_enable_x64`` (its tests and its
    estimation run so)."""
    return torch.float64


def petlion(chemistry: Callable = LCO, *, device="cuda",
            dtype: Optional[torch.dtype] = None, **kwargs) -> Model:
    """Model factory: `chemistry(**kwargs)` gives (θ, bounds, opts, N,
    numerics); θ becomes tensors on `device` in `dtype` (default
    ``default_dtype()``)."""
    dtype = default_dtype() if dtype is None else dtype
    theta, bounds, opts, N, numerics = chemistry(**kwargs)
    _check_errors_initial(theta, numerics)
    return make_model(theta, bounds, opts, N, numerics, device=device,
                      dtype=dtype)


def _check_parameters_runtime(p: Model):
    """θ must describe a physical cell."""
    th = p.theta_floats()
    eps_sp, eps_sn = active_material(th)
    if not (0.0 <= eps_sp <= 1.0):
        raise ValueError("eps_p + eps_fp must be in [0, 1)")
    if not (0.0 <= eps_sn <= 1.0):
        raise ValueError("eps_n + eps_fn must be in [0, 1)")
    if th["theta_max_p"] > th["theta_min_p"]:
        raise ValueError("theta_max_p must be < theta_min_p")
    if th["theta_min_n"] > th["theta_max_n"]:
        raise ValueError("theta_min_n must be < theta_max_n")


def _check_initial_soc(bounds: dict, soc: float, spec, value: float):
    """A new constant-current run must leave room in the (dis)charge
    direction (only a constant current decides it)."""
    if spec.method != "I" or spec.func is not None or value == 0:
        return
    soc_max = float(bounds.get("SOC_max", math.nan))
    soc_min = float(bounds.get("SOC_min", math.nan))
    if value > 0 and not math.isnan(soc_max) and soc >= soc_max:
        raise ValueError(
            f"initial SOC ({soc}) must be < SOC_max ({soc_max}) when charging")
    if value < 0 and not math.isnan(soc_min) and soc <= soc_min:
        raise ValueError(
            f"initial SOC ({soc}) must be > SOC_min ({soc_min}) when "
            f"discharging")


def _build_control(p: Model, sol: Optional[Solution], kwargs):
    """Identify the control method and build (name, spec, value, is_rest,
    is_temperature_hold): a constant, a function (batch-first, see
    ``solver/control.py``), "rest" (I and P; I = 0 turns the bound checks
    off) or "hold" (the previous run's last value) for I/V/P/η_p; the
    dc_s_p_*/dc_s_n_*/dc_e_* derivative holds; and `res` as `(value, f)` or
    `f`; and the thermal model's dT (a rate of the mean temperature: "hold"
    for 0, a number or a function) and T="hold"."""
    given = [k for k in _METHOD_KEYS if k in kwargs]
    if len(given) != 1:
        raise ValueError(
            f"choose exactly one input from {_METHOD_KEYS}; got {given}")
    name = given[0]
    inp = kwargs.pop(name)
    L = p.cfg.layout
    is_rest = is_temperature_hold = False
    value = 0.0

    if name in ("I", "V", "P", "eta_p"):
        if callable(inp):
            spec = ctrl.ControlSpec(name, ctrl.normalize_func(inp))
        elif isinstance(inp, str):
            spec = ctrl.ControlSpec(name)
            if inp == "rest":
                if name not in ("I", "P"):
                    raise ValueError(f"'rest' unsupported for {name}")
                is_rest = name == "I"
            elif inp == "hold":
                if sol is None or not sol:
                    raise ValueError("cannot use 'hold' without a previous simulation")
                y = np.asarray(sol.Y_final)
                value = float({"I": L.I(y), "V": L.V(y),
                               "P": L.I(y) * p.I1C * L.V(y),
                               "eta_p": L.eta_plating(y)}[name])
            else:
                raise ValueError(f"unsupported input symbol {inp!r}")
        else:
            spec = ctrl.ControlSpec(name)
            value = float(inp)
    elif name in ("dT", "T"):
        if not p.numerics.temperature:
            raise ValueError("temperature must be enabled for dT/T control")
        if name == "T" and inp != "hold":
            raise ValueError("T only accepts 'hold'; use dT for protocols")
        is_temperature_hold = True
        cfg = p.cfg

        def dT_meas(t, y, yp, th):
            return events._mean_T(cfg.layout.get(yp, "T"), th, cfg)

        if callable(inp):
            f = ctrl.normalize_func(inp)
            spec = ctrl.ControlSpec(
                "res", lambda t, y, yp, th: dT_meas(t, y, yp, th)
                - ctrl.cell_values(f(t, y, yp, th), y))
        else:
            spec = ctrl.ControlSpec("res", dT_meas)
            value = 0.0 if inp == "hold" else float(inp)
    elif name.startswith("dc_"):
        # derivative hold on the extremal node of the run's starting state,
        # picked per cell (batched cells may hold different nodes)
        if name.startswith("dc_s"):
            electrode = name[5]
            if electrode == "n" and p.cfg.half_cell:
                raise ValueError(
                    "dc_s_n_* controls are meaningless for a half-cell "
                    "(the lithium foil has no solid concentration states)")
            idx_all = L.c_s_surface_slice(electrode)
        else:
            s = L.sl("c_e")
            idx_all = np.arange(s.start, s.stop)
        pick = torch.argmax if name.endswith("max") else torch.argmin

        def init_aux(y0, th, idx_all=idx_all, pick=pick):
            idx = torch.as_tensor(idx_all, device=y0.device)
            return idx[pick(y0[:, idx], dim=-1)][:, None]

        def deriv(t, y, yp, th):
            return torch.gather(yp, 1, th["_ctrl_aux"])[:, 0]

        spec = ctrl.ControlSpec("res", deriv, init_aux=init_aux)
        value = 0.0 if (isinstance(inp, str) and inp == "hold") else float(inp)
    else:  # res
        if isinstance(inp, tuple):
            value, f = float(inp[0]), ctrl.normalize_func(inp[1])
        else:
            f = ctrl.normalize_func(inp)
        spec = ctrl.ControlSpec("res", f)
    return name, spec, value, is_rest, is_temperature_hold


def _host(tensors: dict) -> dict:
    """Numpy copies of a run's tensors, in one device-to-host copy (each
    value is exact in float64: the run's floats, counts and flags)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors.values()])
    host = flat.cpu().numpy()
    out, i = {}, 0
    for k, t in tensors.items():
        n = t.numel()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = host[i:i + n].reshape(tuple(t.shape)).astype(np_dtype)
        i += n
    return out


def simulate(p: Model,
             tf: Union[float, list, np.ndarray, None] = None,
             *,
             sol: Optional[Solution] = None,
             initial_states=None,
             SOC: Optional[float] = None,
             fast_solver: bool = True,
             tstops=None,
             tdiscon=None,
             dtype: Optional[torch.dtype] = None,
             device=None,
             **kwargs) -> Solution:
    """Run one control segment for one cell; continue a previous run by
    passing sol=.

    `tf` is a duration, or a grid of times at which the returned solution is
    interpolated. `tstops` are explicit stop times and `tdiscon` known input
    discontinuities (each stop placed reltol/2 before it), on the
    solution's time axis. `dtype` and `device` default to the model's.
    `fast_solver` False takes the dense route: the dense Jacobian and the
    equilibrated pivoted LU, no plan (the JAX package's cross-check).
    Returns the new Solution, or `sol` extended in place.
    """
    dtype = p.dtype if dtype is None else dtype
    dev = resolve_device(p.device if device is None else device, dtype)
    kw = dict(dtype=dtype, device=dev)
    th = {k: v.to(**kw).reshape(1, 1) for k, v in p.theta.items()}
    L = p.cfg.layout

    # per-call bound overrides
    bdict = events.bounds_dict(p.bounds)
    for k in events.BOUND_KEYS:
        if k in kwargs:
            bdict[k] = float(kwargs.pop(k))
    bounds = {k: torch.full((1,), v, **kw) for k, v in bdict.items()}

    # per-call option overrides; a continuation keeps the previous run's
    # output selection
    opts = p.opts
    if sol is not None and bool(sol) and getattr(sol, "_outputs", None):
        opts = opts.replace(outputs=sol._outputs)
    overrides = {k: kwargs.pop(k) for k in list(kwargs) if k in _OPT_KEYS}
    if overrides:
        opts = opts.replace(**overrides)

    name, spec, value, is_rest, is_th = _build_control(p, sol, kwargs)
    if kwargs:
        raise TypeError(f"unknown keyword arguments: {sorted(kwargs)}")

    # time horizon: a scalar is a duration, a vector an interpolation grid
    t_grid = None
    if tf is None:
        tf_run = 1e6
    elif np.ndim(tf) > 0:
        t_grid = np.asarray(tf, float)
        tf_run = float(t_grid[-1])
    else:
        tf_run = float(tf)

    continuing = sol is not None and bool(sol)
    if continuing and initial_states is not None:
        raise ValueError("cannot set initial_states and continue a run")
    thermal = p.numerics.temperature
    if continuing:
        # the internal carry (T − T_amb): converting through absolute kelvin
        # would round the gradients to ulp(313 K) in float32
        y_int = getattr(sol, "_Y_final_int", None)
        y_start = torch.as_tensor(np.asarray(sol.Y_final if y_int is None else y_int),
                                  **kw).reshape(1, -1)
        if y_int is None and thermal:
            y_start = absolute_T(y_start, th, p.cfg, -1.0)
        soc0 = torch.full((1,), float(sol.SOC_final), **kw)
        prev_I = L.I(y_start)
        has_prev = torch.ones(1, dtype=torch.bool, device=dev)
        t_offset = float(sol.t[-1]) + 1e-12
    elif initial_states is not None:
        # external states carry absolute T [K]
        y_start = torch.as_tensor(np.asarray(initial_states), **kw).reshape(1, -1)
        if thermal:
            y_start = absolute_T(y_start, th, p.cfg, -1.0)
        soc0 = L.soc_from_state(y_start, th)
        prev_I = L.I(y_start)
        has_prev = torch.ones(1, dtype=torch.bool, device=dev)
        t_offset = 0.0
    else:
        soc_f = float(p.opts.SOC if SOC is None else SOC)
        _check_parameters_runtime(p)
        _check_initial_soc(bdict, soc_f, spec, value)
        soc0 = torch.full((1,), soc_f, **kw)
        y_start = initial_guess(soc0, th, p.cfg)
        prev_I = torch.zeros(1, **kw)
        has_prev = torch.zeros(1, dtype=torch.bool, device=dev)
        t_offset = 0.0

    if opts.verbose:
        if spec.func is not None:
            desc = f"{name} function"
        else:
            unit = {"I": "C", "V": " V", "P": " W/m²"}.get(name, "")
            desc = f"{name} = {value:g}{unit}"
        print(f"\nRun for {desc} from t = {t_offset:.2f} s "
              f"(SOC {float(soc0[0]):.4f})")

    # warm-start cache: seed the algebraic block from an earlier identical
    # initialization, keyed by (method, SOC, setpoint); kept on the host
    ws_key = None
    if opts.save_start:
        cache = getattr(p, "_save_start", None)
        if cache is None:
            cache = p._save_start = {}
        ws_key = (name, round(float(soc0[0]), 4), round(value, 4))
        if ws_key in cache:
            y_start = y_start.clone()
            y_start[0, L.N_diff:] = torch.as_tensor(cache[ws_key], **kw)

    # explicit stop times and known input discontinuities, on this run's
    # time axis
    stops = [float(t) for t in (tstops if tstops is not None else ())]
    stops += [float(t) - opts.reltol / 2 for t in (tdiscon if tdiscon is not None else ())]
    stops_t = sorted(t - t_offset for t in stops if t - t_offset > 0)
    stops_dev = torch.tensor([stops_t], **kw) if stops_t else None

    with torch.no_grad():
        plan = get_plan(p.cfg, p.theta_floats()) if fast_solver else None
        res = run_once(y_start=y_start, soc0=soc0, value=torch.full((1,), value, **kw),
                       tf=tf_run, th=th, bounds=bounds, cfg=p.cfg, spec=spec,
                       opts=opts, jac_plan=plan, is_rest=is_rest,
                       is_temperature_hold=is_th, prev_I=prev_I,
                       has_prev=has_prev, tstops=stops_dev)

    out = sol if continuing else Solution()
    h, meta = append_run(out, res, p, name,
                         repr(value) if spec.func is None else "function", t_offset)
    if ws_key is not None and ws_key not in p._save_start:
        p._save_start[ws_key] = h["y0_run"][L.N_diff:]
    out._outputs = opts.outputs
    if opts.verbose:
        print(out)
    if meta["flag"] == -2:
        warnings.warn(f"solver failure in run {name} "
                      f"(init_converged={meta['init_converged']}, "
                      f"steps={meta['n_steps']})")
    if meta["truncated"]:
        warnings.warn(
            f"run {name} accepted {meta['n_steps']} steps but max_save="
            f"{opts.max_save} output slots: the recorded tail was "
            f"overwritten (raise max_save= to keep the full trajectory)")
    if t_grid is not None:
        return out(t_grid, interp_bc=opts.interp_bc)
    return out


def append_run(out: Solution, res, p: Model, method: str, input_repr: str,
               t_offset: float):
    """Append cell 0 of a run's result to `out` on the host, in one
    device-to-host copy: its buffers, the run's metadata and the public
    Y_final (absolute T [K]), with the internal T − T_amb state kept
    alongside for a lossless continuation. Returns (the host values, the
    run's metadata)."""
    fields = {f"buf_{k}": v[0] for k, v in res.bufs.items()}
    for k in ("n_saved", "flag", "y0_run", "y_final", "yp_final", "soc_final",
              "t_final", "n_steps", "n_rejected", "init_converged", "truncated"):
        fields[k] = getattr(res, k)[0]
    h = _host(fields)
    flag = int(h["flag"])
    meta = dict(
        method=method, input_repr=input_repr,
        tspan=(t_offset, t_offset + float(h["t_final"])),
        flag=flag, exit_reason=exit_reason_string(flag),
        n_steps=int(h["n_steps"]), n_rejected=int(h["n_rejected"]),
        init_converged=bool(h["init_converged"]), truncated=bool(h["truncated"]))
    out.append_run({k[4:]: v for k, v in h.items() if k.startswith("buf_")},
                   int(h["n_saved"]), t_offset, meta, public_y(h["y_final"], p),
                   h["yp_final"], h["soc_final"])
    out._Y_final_int = h["y_final"]
    return h, meta


def public_y(y, p: Model) -> np.ndarray:
    """A host state (N,) in the public convention: absolute T [K]."""
    if not p.numerics.temperature:
        return y
    y = np.array(y)
    y[p.cfg.layout.sl("T")] += float(p.theta["T_amb"])
    return y


def _mean_T_host(y, p: Model) -> float:
    """Thickness-weighted mean of the T block of a host state (N,)."""
    th = {k: torch.tensor([[float(v)]], dtype=torch.float64)
          for k, v in p.theta.items()}
    T = torch.as_tensor(np.asarray(y, dtype=np.float64))[None, p.cfg.layout.sl("T")]
    return float(events._mean_T(T, th, p.cfg)[0])


def simulate_cont(sol: Solution, p: Model, tf=None, **kwargs) -> Solution:
    """Continue `sol` in place with another control segment."""
    return simulate(p, tf, sol=sol, **kwargs)


# ---------------------------------------------------------------------------
# state-vector accessors
# ---------------------------------------------------------------------------

def _state(y, p: Model):
    y = torch.as_tensor(np.asarray(y) if not torch.is_tensor(y) else y,
                        device=p.device)
    th = {k: v.to(y.dtype) for k, v in p.theta.items()}
    return y, th


def calc_OCV(y, p: Model):
    """Open-circuit voltages (U_p, U_n) of every cathode and anode CV at the
    particle-surface stoichiometries of state `y` (N_tot,) or (B, N_tot),
    in the public convention (absolute T [K], as Solution.Y_final). Half
    cell: U_n is the lithium foil's 0 V."""
    L, num = p.cfg.layout, p.numerics
    y, th = _state(y, p)
    if num.temperature:
        # `y` in the public convention: absolute T [K]
        T_p, T_n = L.get(y, "T", "p"), L.get(y, "T", "n")
    else:
        T_p = torch.full((p.N.p,), float(th["T0"]), dtype=y.dtype, device=y.device)
        T_n = torch.full((p.N.n,), float(th["T0"]), dtype=y.dtype, device=y.device)
    U_p, _ = num.OCV_p(L.c_s_surf(y, "p") / th["c_max_p"], T_p, th)
    if p.cfg.half_cell:
        # the lithium foil's 0 V against Li/Li⁺
        return U_p, torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype,
                                device=y.device)
    U_n, _ = num.OCV_n(L.c_s_surf(y, "n") / th["c_max_n"], T_n, th)
    return U_p, U_n


def calc_R_internal(y, p: Model):
    """Apparent internal resistance |(V − OCV)/I| [Ω·m²] of state `y`: the
    OCV across the current-collector-facing surfaces, I in A/m²."""
    L = p.cfg.layout
    y, th = _state(y, p)
    I = L.I(y) * calc_I1C(th)
    U_p, U_n = calc_OCV(y, p)
    return torch.abs((L.V(y) - (U_p[..., 0] - U_n[..., -1])) / I)
