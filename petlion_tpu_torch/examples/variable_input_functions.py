"""Port of examples/variable_input_functions.py (the reference's
variable_input_functions.ipynb): time-dependent and state-feedback inputs.

Departs from the JAX script in ``--device`` (default cuda), and in its
functions, which are batch-first torch code: t is a (B,) tensor, y and yp
(B, N), θ a dict of (B, 1) tensors, and the result a tensor on the run's
device (the JAX script's take one cell in jnp).
"""
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser


def feedback(t, y, yp, th):
    """State-feedback current: f(t, y, yp, th) sees the full state."""
    V = y[:, 280] - y[:, 299]      # Φ_s ends (layout of the default model)
    return 5.0 * (V - 4.0)         # push toward 4.0 V


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(ptt.LCO, device=args.device)

    # sinusoidal current
    sol = ptt.simulate(p, 600.0, I=lambda t: -torch.cos(2 * torch.pi * t / 600), SOC=0.5)
    print("sinusoidal I:", sol)

    # ramped power
    sol = ptt.simulate(p, 600.0, P=lambda t: -10.0 - t / 60.0, SOC=0.8)
    print("ramped P:", sol)

    sol = ptt.simulate(p, 600.0, I=feedback, SOC=0.5)
    print("feedback I:", sol)


if __name__ == "__main__":
    main()
