"""Port of examples/model_inputs_and_outputs.py (the reference's
model_inputs_and_outputs.ipynb): output selection, interpolation, per-run
views.

Departs from the JAX script only in ``--device`` (default cuda).
"""
import numpy as np

import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(ptt.LCO, device=args.device)
    sol = ptt.simulate(p, I=-1, SOC=1, outputs=("all",))
    print("recorded outputs:", sorted(sol.arrays))
    print("c_e trace shape:", sol.c_e.shape)

    # interpolate onto a uniform grid (reference sol(0:60:3600))
    si = sol(np.arange(0, 3601, 60))
    print("interpolated V at t=1800:", float(si.V[30]))

    # per-run views
    sol2 = ptt.simulate_cont(sol, p, 900.0, I="rest")
    print("run 0:", sol2[0].final_exit_reason(), "| run 1:", sol2[1].final_exit_reason())


if __name__ == "__main__":
    main()
