"""Run the examples one at a time, each as
``python -m petlion_tpu_torch.examples.<name>`` in a subprocess of its own,
and print each one's wall, exit code and last line of output:

    python -m petlion_tpu_torch.examples [--device cpu] [name ...]

(default: all nine, on the card). The examples write their files into the
current directory.
"""

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

NAMES = ("getting_started", "model_inputs_and_outputs", "variable_input_functions",
         "cc_cv", "gitt", "updating_parameters", "multichip_sweep",
         "fast_charging_cc_ct_cv", "parameter_estimation")
ROOT = Path(__file__).resolve().parents[2]


def run_one(name: str, args=(), cwd=None, timeout=1800, env=None):
    """(exit code, wall seconds, stdout, stderr) of one example run as
    ``python -m`` with this checkout on its path; a run past `timeout` is
    killed and raises."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"petlion_tpu_torch.examples.{name}", *args],
                       cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    return r.returncode, time.perf_counter() - t0, r.stdout, r.stderr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(NAMES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    failed = []
    for name in args.names:
        rc, wall, out, err = run_one(name, ["--device", args.device])
        last = (out.strip().splitlines() or [""])[-1]
        print(f"{name}: exit {rc}, {wall:.3f} s; last line: {last}", flush=True)
        if rc != 0:
            failed.append(name)
            print(err[-2000:], file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
