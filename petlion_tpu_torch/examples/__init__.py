"""The JAX package's nine ``examples/*.py`` on the port, one module each
with the same name and flow at the script's own settings:

    python -m petlion_tpu_torch.examples.<name> [--device cpu]

Each runs on the card unless given ``--device cpu`` and prints what its
JAX twin prints. Each module's docstring names where it departs from the
script.
"""

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' common ``--device``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: cuda; cpu for a host run)")
    return ap


def save_trace(sol, name: str, state: str = "V"):
    """Save `state` over t as ``<name>.npz`` (always) and ``<name>.png``
    (where matplotlib imports), printing the name of each file."""
    import numpy as np
    np.savez(f"{name}.npz", t=sol.t, **{state: getattr(sol, state)})
    print(f"saved {name}.npz")
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    sol.plot(state).figure.savefig(f"{name}.png", dpi=120)
    print(f"saved {name}.png")
