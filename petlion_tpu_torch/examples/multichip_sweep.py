"""Port of examples/multichip_sweep.py: a data-parallel parameter sweep
with the cells axis split over a device mesh.

The reference sweeps parameters by re-running `simulate` in a user loop
(examples/updating_parameters.ipynb cell 4); here the fleet is one
``batch_simulate`` whose cells are cut into one shard a device of
``make_cell_mesh`` (cells never couple: no communication between shards):

    python -m petlion_tpu_torch.examples.multichip_sweep            # every card
    python -m petlion_tpu_torch.examples.multichip_sweep --devices cpu,cpu \\
        --cells-per-device 2                                         # host "devices"

Departs from the JAX script in the mesh: every visible CUDA device by
default (``--device cpu`` a one-device CPU mesh), or ``--devices`` named
one by one (a device may repeat: the stand-in for the JAX script's eight
virtual CPU devices); and in ``--cells-per-device`` (default 64, the
script's). The sweep runs in float32, as the script's.
"""
import numpy as np
import torch

import petlion_tpu_torch as ptt
from petlion_tpu_torch.examples import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--devices", default=None,
                    help="comma-separated mesh devices (default: every CUDA device)")
    ap.add_argument("--cells-per-device", type=int, default=64)
    args = ap.parse_args(argv)
    if args.devices:
        mesh = ptt.make_cell_mesh("cells", devices=args.devices.split(","))
    elif args.device == "cuda":
        mesh = ptt.make_cell_mesh("cells")
    else:
        mesh = ptt.make_cell_mesh("cells", devices=[args.device])
    print(f"mesh: {mesh.size} × {mesh.devices[0].type}")

    p = ptt.petlion(ptt.LCO, device=mesh.devices[0], dtype=torch.float32)
    p.opts = p.opts.replace(abstol=5e-4, reltol=1e-3, max_save=2)

    B = args.cells_per_device * mesh.size       # batch divisible by the mesh
    rng = np.random.default_rng(0)
    theta_batch = {                             # per-cell sweep of 4 θ leaves
        "D_sp": 1e-14 * (1 + 0.1 * rng.standard_normal(B)),
        "k_p": 2.334e-11 * (1 + 0.1 * rng.standard_normal(B)),
        "D_sn": 3.9e-14 * (1 + 0.1 * rng.standard_normal(B)),
        "k_n": 5.031e-11 * (1 + 0.1 * rng.standard_normal(B)),
    }
    res = ptt.batch_simulate(p, 3.9e3, I=-1.0, SOC=1.0, theta_batch=theta_batch,
                             mesh=mesh, outputs=("t", "V"))

    ok = np.isin(res.flag.cpu().numpy(), (0, 1, 3))
    n_saved = int(res.n_saved.min())
    V = res.bufs["V"][:, n_saved - 1].cpu().numpy()   # per-cell final voltage
    print(f"completed {ok.sum()}/{B} discharges;"
          f" end-of-discharge V spread {V.min():.4f}-{V.max():.4f} V"
          f" (the θ sweep drives the polarization spread)")


if __name__ == "__main__":
    main()
