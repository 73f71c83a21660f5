"""Port of examples/updating_parameters.py (the reference's
updating_parameters.ipynb): θ swapped between single-cell runs, then the
same sweep as one batched run.

Departs from the JAX script in ``--device`` (default cuda), and in setting
θ as tensors on the model's device (the port's θ are tensors).
"""
import numpy as np
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(ptt.LCO, device=args.device)

    # single-cell swap of θ between runs (the plan is built once)
    for D_sp in (0.5e-14, 1e-14, 2e-14):
        p.theta["D_sp"] = torch.tensor(D_sp, dtype=p.dtype, device=p.device)
        sol = ptt.simulate(p, I=-1, SOC=1)
        print(f"D_sp={D_sp:g}: V_end={sol.V[-1]:.4f} t_end={sol.t[-1]:.0f}s")
    p.theta["D_sp"] = torch.tensor(1e-14, dtype=p.dtype, device=p.device)

    # batched sweep: all cells in one run
    B = 64
    res = ptt.batch_simulate(p, I=-1.0, SOC=1.0, outputs=("t", "V"), max_save=4,
                             theta_batch={"D_sp": 1e-14 * np.logspace(-0.5, 0.5, B)})
    iV = res.n_saved.cpu().numpy() - 1
    V_end = res.bufs["V"].cpu().numpy()[np.arange(B), iV]
    print(f"batched sweep of {B} cells: V_end in [{V_end.min():.4f}, {V_end.max():.4f}]")


if __name__ == "__main__":
    main()
