"""Port of examples/parameter_estimation.py: Gauss-Newton recovery of
D_sp and k_n from a synthetic discharge curve, with exact dV/dθ from
forward-mode differentiation through the whole adaptive solve.

Departs from the JAX script in ``--device`` (default cuda), and in setting
θ as tensors on the model's device (the port's θ are tensors).
"""
import numpy as np
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch import estimation
from petlion_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(ptt.LCO, device=args.device)

    def set_theta(**values):
        for k, v in values.items():
            p.theta[k] = torch.tensor(v, dtype=p.dtype, device=p.device)

    # synthetic "measured" discharge curve at hidden true parameters
    true = {"D_sp": 1.7e-14, "k_n": 3.1e-11}
    t_data = np.linspace(60.0, 1700.0, 24)
    set_theta(**true)
    voltage, th_true = estimation.make_voltage_model(p, list(true), t_eval=t_data,
                                                     I_crate=-1.0, SOC=0.9)
    V_data = voltage(th_true).cpu().numpy()

    # start from a badly perturbed guess and fit
    set_theta(D_sp=1e-14, k_n=5.031e-11)
    fitted = estimation.fit(p, list(true), t_data, V_data, I_crate=-1.0, SOC=0.9,
                            iters=10, verbose=True)
    for k in true:
        print(f"{k}: true={true[k]:.4g} fitted={fitted[k]:.4g} "
              f"err={abs(fitted[k] - true[k]) / true[k]:.2e}")


if __name__ == "__main__":
    main()
