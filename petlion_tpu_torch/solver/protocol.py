"""Multi-segment protocols for a batch of cells — CC-CV, CC-CT-CV, cycling
(counterpart of the JAX package's ``solver/protocol.py``).

A protocol is a static tuple of segments. Each segment is one batch-first
run (consistent re-initialization → adaptive BDF → events) over every cell;
the carry from one segment to the next is each cell's own final state, SOC
and current, and a ``hold`` setpoint is measured per cell from that carry.
Cells go through segment k in lockstep: a cell that has met its stop
condition idles under its mask until every cell of the batch has, and then
all start segment k + 1 — the semantics of the JAX package's vmap over the
unrolled segments. A batched CC-CV sweep with per-cell switch times is
therefore exact for every cell.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import SimOptions
from ..physics.residuals import ModelConfig
from . import control as ctrl
from . import events
from .run import run_once


@dataclasses.dataclass(frozen=True)
class Segment:
    """Static description of one protocol segment.

    value_mode: "given" (the segment's setpoint), "hold" (measured per cell
    from the carry state), "rest" (zero current)."""
    spec: ctrl.ControlSpec
    value_mode: str = "given"
    is_rest: bool = False
    is_temperature_hold: bool = False

    def __post_init__(self):
        if self.value_mode not in ("given", "hold", "rest"):
            raise ValueError(self.value_mode)


def protocol_core(y_start, soc0, values, tfs, th, bounds_list,
                  cfg: ModelConfig, segments: Tuple[Segment, ...],
                  opts: SimOptions, jac_plan) -> list:
    """Run all segments one after another on a batch.

    y_start (B, N), soc0 (B,); values, tfs: each segment's setpoint (ignored
    for hold and rest) and duration; th: dict of (B, 1) θ tensors;
    bounds_list: one dict of (B,) bound tensors per segment. Returns one
    RunResultDev per segment, each with a leading cells axis."""
    L = cfg.layout
    B = y_start.shape[0]
    y, soc = y_start, soc0
    prev_I = torch.zeros(B, dtype=y.dtype, device=y.device)
    has_prev = torch.zeros(B, dtype=torch.bool, device=y.device)
    results = []
    for k, seg in enumerate(segments):
        if seg.value_mode == "hold":
            value = ctrl.measured(seg.spec, y, th, cfg)
        else:
            v = 0.0 if seg.value_mode == "rest" else float(values[k])
            value = torch.full((B,), v, dtype=y.dtype, device=y.device)
        res = run_once(y_start=y, soc0=soc, value=value, tf=tfs[k], th=th,
                       bounds=bounds_list[k], cfg=cfg, spec=seg.spec,
                       opts=opts, jac_plan=jac_plan, is_rest=seg.is_rest,
                       is_temperature_hold=seg.is_temperature_hold,
                       prev_I=prev_I, has_prev=has_prev)
        results.append(res)
        y, soc = res.y_final, res.soc_final
        prev_I = L.I(y)
        has_prev = torch.ones_like(has_prev)
    return results


def build_segments(p, segment_dicts):
    """User dicts → (segments, values, tfs, bounds_list) on the host.

    Each dict: one control key (I/V/P/eta_p/res/dT/...) whose value is a
    number, "hold", "rest" or a batch-first function; optionally "tf" (a
    duration, default 1e6) and bound overrides (V_max=..., SOC_min=...)."""
    from ..sim import _build_control

    segments, values, tfs, bounds_list = [], [], [], []
    for d in segment_dicts:
        d = dict(d)
        tf = float(d.pop("tf", 1e6))
        bdict = events.bounds_dict(p.bounds)
        for k in events.BOUND_KEYS:
            if k in d:
                bdict[k] = float(d.pop(k))
        # the value mode is read before _build_control, which would need a
        # previous solution for "hold": a numeric placeholder stands in
        mode = "given"
        for mk in ("I", "V", "P", "eta_p", "dT", "T"):
            if mk in d and isinstance(d[mk], str):
                if d[mk] == "hold":
                    mode = "hold"
                    if mk not in ("dT", "T"):
                        d[mk] = 1.0
                elif d[mk] == "rest":
                    mode = "rest"
                    d[mk] = 0.0
        _, spec, value, is_rest, is_th = _build_control(p, None, d)
        if d:
            raise TypeError(f"unknown segment keys: {sorted(d)}")
        if mode == "hold" and spec.method == "res":
            mode = "given"    # the dT hold: its value 0 is already set
        if mode == "rest":
            is_rest = spec.method == "I"
        segments.append(Segment(spec=spec, value_mode=mode, is_rest=is_rest,
                                is_temperature_hold=is_th))
        values.append(value if mode == "given" else 0.0)
        tfs.append(tf)
        bounds_list.append(bdict)
    return tuple(segments), values, tfs, tuple(bounds_list)
