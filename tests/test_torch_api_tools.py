"""The port's last modules against the JAX package's: profiling (`trace`,
`Timer`), `batch_cost_analysis` with the kernels' formulas in
`ops/cost.py`, the cells axis split over devices (`make_cell_mesh`,
`mesh=`) and `__version__`, on the CPU in float64.

A mesh here repeats the CPU device: each entry is one shard, run from a
host thread of its own (the stand-in for the JAX tests' virtual CPU
devices). The comparison with the JAX package's sharded run and the print
of its cost analysis compile JAX programs and are slow.
"""

import ast
import json
import pathlib
import sys
import threading

import jax  # noqa: F401  (tests/conftest.py: CPU, float64, 8 virtual devices)
import numpy as np
import pytest
import torch

import petlion_tpu as pt
import petlion_tpu_torch as ptt
from petlion_tpu_torch import main_path as mp
from petlion_tpu_torch.ops import cost, dchain, gj_blocks, gj_kernel
from petlion_tpu_torch.solver import run as runner
from petlion_tpu_torch.utils.profiling import Timer, trace

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DISCHARGE = dict(I=-1.0, SOC=1.0)
# the JAX test's sweep (tests/test_batch.py:test_sharded_batch_runs)
SHARDED_TB = {"D_sp": 1e-14 * (1 + 0.02 * np.arange(16))}


@pytest.fixture(scope="module")
def p():
    return ptt.petlion(ptt.LCO, device="cpu")


def test_version_matches_jax():
    assert ptt.__version__ == pt.__version__ == "0.1.0"


def _public_names(pkg: pathlib.Path) -> set:
    """Module-level functions and classes of a package, outside the Pallas
    files, whose names do not start with an underscore."""
    names = set()
    for f in pkg.rglob("*.py"):
        if f.name.startswith("pallas_"):
            continue
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                names.add(node.name)
    return names


def test_every_public_function_has_a_counterpart():
    """Every public function and class of the JAX package has one of its
    name in the port (the batch-first ``bdf.Stepper`` stands for
    ``make_stepper``); the package exports the same version."""
    renamed = {"make_stepper": "Stepper"}
    port = _public_names(ROOT / "petlion_tpu_torch")
    missing = sorted(n for n in _public_names(ROOT / "petlion_tpu")
                     if renamed.get(n, n) not in port)
    assert missing == []
    for name in ("batch_cost_analysis", "make_cell_mesh", "batch_simulate"):
        assert name in ptt.__all__ and callable(getattr(ptt, name))


def test_timer_reports_calls(p):
    """As the JAX package's tests/test_features.py:test_timer_util: two 60 s
    runs, each timed with its result as `sync`."""
    tm = Timer()
    for _ in range(2):
        out = []
        with tm.phase("simulate", sync=out):
            out.append(ptt.simulate(p, 60.0, I=-1, SOC=1))
    rep = tm.report()
    assert "simulate" in rep and "2 calls" in rep and "first" in rep


def test_trace_writes_a_chrome_trace(p, tmp_path):
    with trace(str(tmp_path / "tr")) as logdir:
        ptt.batch_simulate(p, 5.0, n_cells=2, **DISCHARGE)
    files = sorted(pathlib.Path(logdir).glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    aten = [e for e in events if str(e.get("name", "")).startswith("aten::")]
    assert len(aten) > 100


def test_cost_formulas_give_the_perf_table_bytes():
    """PERF.md §6's bounds come from ops/cost.py: K1 at (1024, 71) float32
    moves 41.3 MB (0.0123 ms by bytes), K3ᵗ at (1024, 71) float64 with
    levels (20, 20) 151.7 MB (0.0453 ms)."""
    flops, n_bytes = cost.gj_inverse(1024, 71, 4)
    assert round(n_bytes / 1e6, 1) == 41.3 and flops == 2 * 71 ** 3 * 1024
    ms, by = cost.bound(n_bytes, flops)
    assert by == "bytes" and round(ms, 4) == 0.0123
    flops, n_bytes = cost.dchain_tangent(1024, 71, (20, 20), 8)
    assert round(n_bytes / 1e6, 1) == 151.7
    assert round(cost.bound(n_bytes, flops, fp64=True)[0], 4) == 0.0453
    assert cost.chain_shapes(71, (20, 20)) == dchain.out_shapes(71, (20, 20))
    assert round(cost.dchain(1024, 71, (20, 20), 4)[1] / 1e6, 1) == 41.3


def _count(p, B, **kw):
    return ptt.batch_cost_analysis(p, 3.9e3, theta_batch={"D_sp": 1e-14 * np.ones(B)},
                                   **DISCHARGE, **kw)


def test_cost_analysis_scales_with_cells(p):
    """One trip at B = 2 and B = 4: flops and bytes per cell within 1%; each
    kernel's entry is its launches times its formula; the trip ran one
    factorization (one K1 launch at the 71-state core)."""
    counts = {B: _count(p, B) for B in (2, 4)}
    for key in ("flops", "bytes accessed"):
        a, b = counts[2][key] / 2, counts[4][key] / 4
        assert abs(a - b) <= 0.01 * b, (key, a, b)
    for B, c in counts.items():
        assert c["ops"] > 1000
        k1 = c["kernels"]["gj_inverse"]
        assert k1["launches"] == 1
        f, nb = cost.gj_inverse(B, 71, 8)
        assert (k1["flops"], k1["bytes"]) == (k1["launches"] * f, k1["launches"] * nb)
        assert c["flops"] > k1["flops"] and c["bytes accessed"] > k1["bytes"]


@pytest.mark.parametrize("route, stand_ins", [
    ("path1", [(gj_kernel, "gj_inverse_blocked", lambda A, bs=8: torch.linalg.inv(A))]),
    ("path2", [(gj_blocks, "gj_blocks_plain", lambda A: torch.linalg.inv(A)),
               (dchain, "dchain_plain",
                lambda D, sizes, f=dchain.dchain_plain: f(D, sizes, dchain.inv_equil_inplace))]),
])
def test_cost_analysis_skips_the_stand_ins(p, monkeypatch, route, stand_ins):
    """On the CPU a plain version stands in for each kernel; its own ops are
    not counted (the kernel's formula is): swapping it for another plain
    version leaves the count unchanged, op for op. The full-kernel route
    counts K2 three times (three groups) and K3 once."""
    route = mp.PATHS[route]
    before = _count(p, 2, route=route)
    for mod, name, other in stand_ins:
        monkeypatch.setattr(mod, name, other)
    after = _count(p, 2, route=route)
    assert after == before
    if route.dchain:
        assert before["kernels"]["gj_blocks"]["launches"] == 3
        assert before["kernels"]["dchain"]["launches"] == 1


def test_cost_analysis_of_an_ended_run_raises(p):
    with pytest.raises(ValueError, match="before its first trip"):
        ptt.batch_cost_analysis(p, 0.0, n_cells=2, **DISCHARGE)
    assert runner._TRIP_HOOK.fn is None


def test_make_cell_mesh(monkeypatch):
    mesh = ptt.make_cell_mesh(devices=["cpu", "cpu", torch.device("cpu")])
    assert mesh.size == 3 and mesh.axis_name == "cells"
    assert mesh.devices == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.make_cell_mesh()


def _half_trips(p, tb, kw):
    """Trips of each half of the batch run alone."""
    trips = []
    for half in (slice(0, 2), slice(2, 4)):
        runner.reset_trip_counts()
        ptt.batch_simulate(p, 300.0, theta_batch={k: v[half] for k, v in tb.items()}, **kw)
        trips.append(runner.TRIPS["trips"])
    return trips


def test_split_batch_matches_unsplit(p):
    """Four cells, 300 s of a 1C discharge, split over two CPU "devices"
    against the unsplit run, at the JAX test's tolerances (t_final rtol
    1e-12, y_final 1e-8); the trips of the split run add up the shards';
    the result lies on the mesh's first device with the unsplit run's
    shapes."""
    tb = {"D_sp": SHARDED_TB["D_sp"][:4]}
    kw = dict(outputs=("t", "V"), **DISCHARGE)
    ref = ptt.batch_simulate(p, 300.0, theta_batch=tb, **kw)
    halves = _half_trips(p, tb, kw)
    runner.reset_trip_counts()
    got = ptt.batch_simulate(p, 300.0, theta_batch=tb,
                             mesh=ptt.make_cell_mesh(devices=["cpu"] * 2), **kw)
    assert runner.TRIPS["trips"] == sum(halves)
    assert len(runner.TRIPS["cell_factors"]) == 2
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(b, dict):
            assert a.keys() == b.keys() and all(a[k].shape == b[k].shape for k in b)
        else:
            assert a.shape == b.shape and a.device == b.device
    np.testing.assert_array_equal(got.flag.numpy(), ref.flag.numpy())
    np.testing.assert_allclose(got.t_final.numpy(), ref.t_final.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.y_final.numpy(), ref.y_final.numpy(), rtol=1e-8)


def test_split_batch_refuses_a_bad_mesh(p):
    mesh = ptt.make_cell_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="do not divide"):
        ptt.batch_simulate(p, 60.0, n_cells=3, mesh=mesh, **DISCHARGE)
    with pytest.raises(ValueError, match="axis"):
        ptt.batch_simulate(p, 60.0, n_cells=2, mesh=mesh, axis_name="x", **DISCHARGE)
    with pytest.raises(ValueError, match="not both"):
        ptt.batch_simulate(p, 60.0, n_cells=2, mesh=mesh, device="cpu", **DISCHARGE)
    with pytest.raises(ValueError, match="do not divide"):
        ptt.batch_protocol(p, mp.CCCV_SEGMENTS, n_cells=3, SOC=0.0, mesh=mesh)


def test_split_protocol_matches_unsplit(p):
    """batch_protocol(mesh=...) no longer raises: a CC charge from SOC 0.8
    to V_max and 60 s of the voltage hold, two cells split over two CPU "devices",
    equal the unsplit run segment by segment (t_final rtol 1e-10: on the
    CPU a batched product rounds by its batch size, which moves a switch
    time by ~3e-12; y_final 1e-8)."""
    tb = {"D_sn": 3.9e-14 * np.array([0.5, 2.0])}
    segments = [dict(I=2.0, V_max=4.1, SOC_max=1.0), dict(V="hold", tf=60.0)]
    ref = ptt.batch_protocol(p, segments, SOC=0.8, theta_batch=tb)
    got = ptt.batch_protocol(p, segments, SOC=0.8, theta_batch=tb,
                             mesh=ptt.make_cell_mesh(devices=["cpu"] * 2))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.flag.numpy(), r.flag.numpy())
        np.testing.assert_allclose(g.t_final.numpy(), r.t_final.numpy(), rtol=1e-10)
        np.testing.assert_allclose(g.y_final.numpy(), r.y_final.numpy(), rtol=1e-8)
    assert [int(f) for f in got[0].flag] == [2, 2] and [int(f) for f in got[1].flag] == [0, 0]


def test_counts_add_up_over_threads():
    """Kernel launches and trips counted from many threads at once, with a
    short switch interval: no update is lost."""
    class Lib:
        pass
    threads, calls = 12, 3000
    gj_kernel.reset_launch_counts()
    runner.reset_trip_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(calls):
                gj_kernel.check_launch(Lib(), "gj_inverse", 0, 71)
                runner._count("trips")
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert gj_kernel.LAUNCHES["gj_inverse"] == threads * calls
    assert gj_kernel.LAUNCHES_BY_N["gj_inverse"] == {71: threads * calls}
    assert runner.TRIPS["trips"] == threads * calls
    gj_kernel.reset_launch_counts()
    runner.reset_trip_counts()


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded run of tests/test_batch.py:43-56 (B = 16,
    600 s, the 8-device virtual mesh)."""
    from petlion_tpu.parallel.batch import batch_simulate, make_cell_mesh
    mesh = make_cell_mesh("cells")
    assert mesh.devices.size == 8
    r = batch_simulate(pt.petlion(pt.LCO), 600.0, theta_batch=SHARDED_TB, mesh=mesh,
                       outputs=("t", "V"), **DISCHARGE)
    return np.asarray(r.t_final), np.asarray(r.y_final)


@pytest.mark.slow
def test_split_batch_matches_jax_sharded(p, jax_sharded):
    """The port's run split over eight CPU "devices" against the JAX
    package's run sharded over its eight virtual devices: t_final and
    y_final within rtol 1e-8."""
    got = ptt.batch_simulate(p, 600.0, theta_batch=SHARDED_TB, outputs=("t", "V"),
                             mesh=ptt.make_cell_mesh(devices=["cpu"] * 8), **DISCHARGE)
    t_ref, y_ref = jax_sharded
    np.testing.assert_allclose(got.t_final.numpy(), t_ref, rtol=1e-8)
    np.testing.assert_allclose(got.y_final.numpy(), y_ref, rtol=1e-8)


@pytest.mark.slow
def test_cost_analysis_beside_jax(p):
    """For the record: XLA's count of the JAX package's compiled batched run
    (every while-loop body once) beside the port's count of one trip, 16
    cells. No assertion on their ratio: the two count different things."""
    from petlion_tpu.parallel.batch import batch_cost_analysis
    kw = dict(theta_batch=SHARDED_TB, outputs=("t", "V"), **DISCHARGE)
    jx = batch_cost_analysis(pt.petlion(pt.LCO), 3.9e3, **kw)
    port = ptt.batch_cost_analysis(p, 3.9e3, **kw)
    print(f"\nB = 16 float64: JAX (XLA, one pass of every loop body) flops "
          f"{jx.get('flops')}, bytes accessed {jx.get('bytes accessed')}; port (one "
          f"trip) flops {port['flops']}, bytes accessed {port['bytes accessed']}, "
          f"{port['ops']} ops, kernels {port['kernels']}")
    assert port["flops"] > 0 and jx.get("flops", 0) > 0
