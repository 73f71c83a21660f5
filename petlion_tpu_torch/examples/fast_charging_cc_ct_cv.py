"""Port of examples/fast_charging_cc_ct_cv.py (the reference README's
protocol): 4C charge -> temperature hold -> voltage hold of one thermal
cell, in one protocol call.

Departs from the JAX script only in ``--device`` (default cuda).
"""
import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(ptt.LCO, temperature=True, device=args.device)
    sol = ptt.simulate_protocol(p, [
        dict(I=4, V_max=4.1, T_max=40 + 273.15),
        dict(dT="hold", V_max=4.1),
        dict(V="hold"),
    ], SOC=0.0, outputs=("t", "V", "T"))
    print(sol)   # reference: 1865.61 s, 0.1959C, 25.6963 °C, Above max. SOC


if __name__ == "__main__":
    main()
