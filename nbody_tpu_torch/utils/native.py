"""ctypes binding to the native C++/OpenMP oracle
(``native/libnbody_oracle.so``), the port's own copy of
``nbody_tpu.utils.native``.

An independent ground truth for the force law and the Hilbert key, in f64
on the host: the cross-language analog of the reference's accuracy oracle
(``utils.h:171-219``). Unavailable until the library is built (``make -C
native``); callers check :func:`available`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libnbody_oracle.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.nbody_brute_force.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double)]
    lib.nbody_brute_force.restype = None
    lib.nbody_hilbert_keys.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint32)]
    lib.nbody_hilbert_keys.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native oracle not built; run `make -C native`")
    return lib


def brute_force_native(positions, masses, G: float,
                       softening: float) -> np.ndarray:
    """Double-precision forces [N, D] from the C++/OpenMP oracle (numpy
    inputs, or host tensors)."""
    lib = _lib()
    pos = np.ascontiguousarray(positions, dtype=np.float64)
    mass = np.ascontiguousarray(masses, dtype=np.float64)
    n, dim = pos.shape
    if mass.shape != (n,) or dim not in (2, 3):
        raise ValueError(f"positions [N, 2|3] and masses [N] expected, got "
                         f"{pos.shape} and {mass.shape}")
    out = np.zeros((n, dim), dtype=np.float64)
    lib.nbody_brute_force(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mass.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(n), ctypes.c_int(dim),
        ctypes.c_double(G), ctypes.c_double(softening),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def hilbert_keys_native(coords, bits: int) -> np.ndarray:
    """Hilbert keys [N] (uint32) from quantized grid coords [N, D]."""
    lib = _lib()
    c = np.ascontiguousarray(coords, dtype=np.uint32)
    n, dim = c.shape
    if dim not in (2, 3):
        raise ValueError(f"coords [N, 2|3] expected, got {c.shape}")
    out = np.zeros((n,), dtype=np.uint32)
    lib.nbody_hilbert_keys(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_long(n), ctypes.c_int(dim), ctypes.c_int(bits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out
