"""Port of examples/cc_cv.py (the reference's CC-CV.ipynb): a
constant-current charge, then a voltage hold tapering to C/20.

Departs from the JAX script only in ``--device`` (default cuda).
"""
import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(ptt.LCO, device=args.device)
    sol = ptt.simulate(p, I=2, SOC=0, V_max=4.1, outputs=("t", "V"))
    sol = ptt.simulate_cont(sol, p, V="hold", I_min=1 / 20)   # taper to C/20
    print(sol)
    print("exit reasons:", ptt.exit_reasons(sol))


if __name__ == "__main__":
    main()
