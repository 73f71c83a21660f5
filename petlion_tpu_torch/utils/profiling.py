"""Profiling helpers (counterpart of the JAX package's
``utils/profiling.py``): a device trace and a phase timer.

The JAX package traces with ``jax.profiler``; here ``torch.profiler``
records the host's aten ops and, when the process has a card, the CUDA
kernels (the hand-written ones under their own symbols) into a
Chrome/Perfetto trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a profile: ``with profiling.trace(): res = batch_simulate(...)``.

    Writes ``trace_<pid>_<n>.json`` into `logdir` (default
    ``petlion_tpu_torch_trace`` in the temporary directory, where the JAX
    package traces too) when the block ends: CPU activity, and CUDA
    activity when a card is visible. Yields `logdir`. Open the file with
    ui.perfetto.dev or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "petlion_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def _cuda_devices(obj, found: set):
    """The CUDA devices of the tensors in `obj`: a tensor, a (named) tuple,
    list or dict of them, or a dataclass whose fields hold them (a
    ``Solution`` keeps its arrays on the host and holds none)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)
    return found


class Timer:
    """Wall-clock phase timer distinguishing the first call (kernel builds,
    plan construction) from the steady state, with device sync."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; with `sync` (a tensor, ``RunResultDev``,
        ``Solution`` or a nested tuple, list or dict of them) wait for every
        CUDA device it holds before reading the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                for dev in _cuda_devices(sync, set()):
                    torch.cuda.synchronize(dev)
            self.phases.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.phases.items():
            best = min(ts)
            lines.append(f"{name}: best {best * 1e3:.2f} ms over {len(ts)} "
                         f"calls (first {ts[0] * 1e3:.2f} ms)")
        return "\n".join(lines)
