from .cells import LCO, NMC, NMC_LGM50, Li_metal_theta  # noqa: F401
