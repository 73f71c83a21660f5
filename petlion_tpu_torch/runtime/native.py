"""ctypes bindings for the port's native (C++) host runtime,
``petlion_tpu_torch/csrc/native.cpp``: natural cubic splines and the
banded+arrowhead LU of the P2D Newton matrix (counterpart of the JAX
package's ``runtime/native.py``, with its own copy of the source).

The library is built at first use with ``g++ -O3 -fPIC -shared`` into
``build/native/`` at the repository root, one library per source version,
and loaded from there. Where no C++ compiler is found or the build fails,
``available()`` is False and callers use their numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops.dual import refuse

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_tried = False


def _so_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libnative_{h.hexdigest()[:12]}.so"


def _build(so: Path):
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _so_path()
    try:
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None
    i64, dp = ctypes.c_int64, ctypes.POINTER(ctypes.c_double)
    lib.cubic_spline_interp.restype = ctypes.c_int
    lib.cubic_spline_interp.argtypes = [i64, dp, i64, dp, i64, dp, dp,
                                        ctypes.c_int]
    lib.banded_arrow_factor.restype = ctypes.c_int
    lib.banded_arrow_factor.argtypes = [i64, i64, i64, dp, dp]
    lib.banded_arrow_solve.restype = ctypes.c_int
    lib.banded_arrow_solve.argtypes = [i64, i64, i64, dp, dp, dp, dp]
    lib.version.restype = ctypes.c_int
    lib.version.argtypes = []
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def spline_interp(t, y, t_query, extrapolate=False):
    """Natural cubic spline; y is (n,) or (n, m). Returns query values.
    A tensor with a forward-mode tangent raises: the host copy would drop it."""
    refuse("spline_interp", t, y, t_query)
    lib = _load()
    if lib is None:
        raise RuntimeError("the native runtime is not built")
    t = np.ascontiguousarray(t, dtype=np.float64)
    y2 = np.ascontiguousarray(y, dtype=np.float64)
    squeeze = y2.ndim == 1
    if squeeze:
        y2 = y2[:, None]
    if t.ndim != 1 or y2.ndim != 2 or y2.shape[0] != len(t):
        raise ValueError(f"t {t.shape} and y {np.shape(y)} do not match")
    tq = np.ascontiguousarray(t_query, dtype=np.float64).reshape(-1)
    out = np.empty((len(tq), y2.shape[1]), dtype=np.float64)
    rc = lib.cubic_spline_interp(len(t), _dp(t), y2.shape[1], _dp(y2),
                                 len(tq), _dp(tq), _dp(out),
                                 1 if extrapolate else 0)
    if rc != 0:
        raise RuntimeError(f"cubic_spline_interp failed: {rc}")
    return out[:, 0] if squeeze else out


def banded_arrow_solve(A, b, kl, ku):
    """Solve the P2D banded+arrowhead system (host, f64). `A` is copied.
    A tensor with a forward-mode tangent raises, as in `spline_interp`."""
    refuse("banded_arrow_solve", A, b)
    lib = _load()
    if lib is None:
        raise RuntimeError("the native runtime is not built")
    A = np.ascontiguousarray(A, dtype=np.float64).copy()
    b = np.ascontiguousarray(b, dtype=np.float64)
    n = A.shape[0]
    if A.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"A {A.shape} and b {b.shape} do not match")
    work = np.empty(2 * n + 2, dtype=np.float64)
    rc = lib.banded_arrow_factor(n, kl, ku, _dp(A), _dp(work))
    if rc != 0:
        raise RuntimeError(f"banded_arrow_factor failed: {rc}")
    x = np.empty(n, dtype=np.float64)
    rc = lib.banded_arrow_solve(n, kl, ku, _dp(A), _dp(work), _dp(b), _dp(x))
    if rc != 0:
        raise RuntimeError(f"banded_arrow_solve failed: {rc}")
    return x
