"""The cells axis split over devices, the cost count and the profiling
helpers on the card, against the same runs on the CPU. They skip where
torch.cuda.is_available() is False. This file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_tools.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch import main_path as mp
from petlion_tpu_torch.ops import gj_kernel as gk
from petlion_tpu_torch.solver import run as runner
from petlion_tpu_torch.utils.profiling import Timer, trace

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

THETA = {"D_sp": 1e-14 * (1 + 0.02 * np.arange(4))}
DISCHARGE = dict(I=-1.0, SOC=1.0, theta_batch=THETA, outputs=("t", "V"))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_split_on_card_matches_unsplit():
    """Four float64 cells, 300 s, over two shards of one card: equal to the
    unsplit run (t_final rtol 1e-12, y_final 1e-8), the result on the first
    device, trips summed over the shards and K1 launched by both."""
    _need_card()
    p = ptt.petlion(ptt.LCO, device="cuda")
    ref = ptt.batch_simulate(p, 300.0, **DISCHARGE)
    gk.reset_launch_counts()
    runner.reset_trip_counts()
    got = ptt.batch_simulate(p, 300.0, mesh=ptt.make_cell_mesh(devices=["cuda:0"] * 2),
                             **DISCHARGE)
    att = (ref.n_steps + ref.n_rejected).cpu().numpy()
    assert runner.TRIPS["trips"] == int(att[:2].max()) + int(att[2:].max())
    assert gk.LAUNCHES["gj_inverse"] >= runner.TRIPS["trips"]
    assert got.y_final.device == torch.device("cuda", 0)
    np.testing.assert_array_equal(got.flag.cpu().numpy(), ref.flag.cpu().numpy())
    np.testing.assert_allclose(got.t_final.cpu().numpy(), ref.t_final.cpu().numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(got.y_final.cpu().numpy(), ref.y_final.cpu().numpy(),
                               rtol=1e-8)


@pytest.mark.parametrize("route", ["path1", "path2"])
def test_cost_count_on_card_matches_cpu(route):
    """One trip of four float32 cells counts the same flops on the card as
    on the CPU, bytes within 1% and the same kernel entries."""
    _need_card()
    p = mp.model(device="cuda")
    counts = [ptt.batch_cost_analysis(p, mp.TF, device=d, route=mp.PATHS[route], **DISCHARGE)
              for d in ("cuda", "cpu")]
    gpu, cpu = counts
    assert gpu["flops"] == cpu["flops"]
    assert abs(gpu["bytes accessed"] - cpu["bytes accessed"]) <= 0.01 * cpu["bytes accessed"]
    assert gpu["kernels"] == cpu["kernels"]


def test_trace_and_timer_on_card(tmp_path):
    """A traced 60 s run holds K1's CUDA kernel events, one per launch; the
    Timer waits for the card through the result."""
    _need_card()
    p = ptt.petlion(ptt.LCO, device="cuda")
    ptt.batch_simulate(p, 60.0, **DISCHARGE)          # plan and library built
    gk.reset_launch_counts()
    tm = Timer()
    out = []
    with tm.phase("run", sync=out), trace(str(tmp_path)) as d:
        out.append(ptt.batch_simulate(p, 60.0, **DISCHARGE))
    (f,) = pathlib.Path(d).glob("trace_*.json")
    events = json.loads(f.read_text())["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and mp.KERNEL_SYMBOLS["gj_inverse"] in e.get("name", "")]
    assert len(k1) == gk.LAUNCHES["gj_inverse"] > 0
    assert "run: best" in tm.report() and "1 calls" in tm.report()
