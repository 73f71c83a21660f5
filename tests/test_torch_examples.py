"""The port's examples (`petlion_tpu_torch/examples/`), one module for each
of the JAX package's `examples/*.py`, run on the CPU.

The cheap tier runs three examples in this process (`main(argv)`, sharing
one plan) and the mesh example as `python -m` at two cells per device; the
rest run as `python -m` at the JAX scripts' own settings and are slow.
Every `examples/*.py` must have its port module, and every port module must
sit in one tier (as the JAX package's tests/test_examples.py enforces for
its scripts).
"""

import importlib
import os
import pathlib

import pytest
import torch

from petlion_tpu_torch.examples.__main__ import NAMES, run_one

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (module, arguments after --device cpu, expected substring of stdout)
IN_PROCESS = [
    ("cc_cv", [], "exit reasons: ['Above max. voltage', 'Above max. SOC']"),
    ("model_inputs_and_outputs", [], "run 0: Below min. SOC | run 1: Final time reached"),
    ("variable_input_functions", [], "feedback I:"),
]
SUBPROCESS = [
    ("multichip_sweep", ["--devices", "cpu,cpu", "--cells-per-device", "2"],
     "completed 4/4 discharges"),
]
SLOW = [
    ("getting_started", [], "saved getting_started_V.npz"),
    ("gitt", [], "saved gitt_V.npz"),
    ("fast_charging_cc_ct_cv", [], "Above max. SOC"),
    ("parameter_estimation", [], "fitted="),
    ("updating_parameters", [], "batched sweep"),
]


def _run_module(name, args, expect, cwd):
    rc, _, out, err = run_one(name, ["--device", "cpu", *args], cwd=cwd,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert rc == 0, out[-2000:] + err[-2000:]
    assert expect in out, out[-2000:]
    return out


@pytest.mark.parametrize("name, args, expect", IN_PROCESS)
def test_example_in_process(name, args, expect, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    importlib.import_module(f"petlion_tpu_torch.examples.{name}").main(["--device", "cpu", *args])
    assert expect in capsys.readouterr().out


@pytest.mark.parametrize("name, args, expect", SUBPROCESS)
def test_example_runs(name, args, expect, tmp_path):
    out = _run_module(name, args, expect, tmp_path)
    assert "mesh: 2 × cpu" in out


@pytest.mark.slow
@pytest.mark.parametrize("name, args, expect", SLOW)
def test_example_runs_slow(name, args, expect, tmp_path):
    _run_module(name, args, expect, tmp_path)


def test_every_example_has_a_port_module_in_one_tier():
    scripts = {f.stem for f in (ROOT / "examples").glob("*.py") if not f.name.startswith("_")}
    modules = {f.stem for f in (ROOT / "petlion_tpu_torch" / "examples").glob("*.py")
               if not f.name.startswith("_")}
    tiers = [name for name, _, _ in IN_PROCESS + SUBPROCESS + SLOW]
    assert modules == scripts, (scripts - modules, modules - scripts)
    assert sorted(tiers) == sorted(modules) == sorted(NAMES)
