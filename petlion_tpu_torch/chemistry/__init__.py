from .cells import LCO  # noqa: F401
