"""Port of examples/getting_started.py (the reference's
getting_started.ipynb): build the default LCO model and run a 1C discharge,
then time five warm runs.

Departs from the JAX script in ``--device`` (default cuda), and in saving
the voltage trace as ``getting_started_V.npz`` always, and as
``getting_started_V.png`` only where matplotlib imports.
"""
import time

import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser, save_trace


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(
        ptt.LCO,
        N_p=10, N_s=10, N_n=10, N_r_p=10, N_r_n=10,
        temperature=False,
        solid_diffusion="Fickian",
        device=args.device,
    )
    print(p)

    t0 = time.time()
    sol = ptt.simulate(p, I=-1, SOC=1)
    print(f"first call (plan build, kernel load): {time.time() - t0:.1f} s")
    print(sol)

    t0 = time.time()
    for _ in range(5):
        sol = ptt.simulate(p, I=-1, SOC=1)
    print(f"warm: {(time.time() - t0) / 5 * 1000:.1f} ms/run")
    save_trace(sol, "getting_started_V")


if __name__ == "__main__":
    main()
