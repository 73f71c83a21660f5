"""Port of examples/gitt.py (the reference's GITT.ipynb): galvanostatic
intermittent titration, ten 0.5C discharge pulses of 6 min each followed by
10 min of rest, as one protocol call.

Departs from the JAX script in ``--device`` (default cuda), and in saving
the voltage trace as ``gitt_V.npz`` always, and as ``gitt_V.png`` only
where matplotlib imports.
"""
import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser, save_trace


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    p = ptt.petlion(ptt.LCO, device=args.device)
    n_pulses = 10
    segments = []
    for _ in range(n_pulses):
        segments.append(dict(I=-0.5, tf=360.0))   # 0.5C pulse, 6 min
        segments.append(dict(I="rest", tf=600.0))  # 10 min relaxation
    sol = ptt.simulate_protocol(p, segments, SOC=1.0, outputs=("t", "V"))
    print(sol)
    print("pulses:", len(sol.results) // 2, " final SOC:", round(float(sol.SOC[-1]), 4))
    save_trace(sol, "gitt_V")


if __name__ == "__main__":
    main()
