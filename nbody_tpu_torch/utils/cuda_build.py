"""Build and load the port's CUDA kernels (``nbody_tpu_torch/csrc``).

The kernels have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes``. The build happens at first use,
from the sources in the package only, into ``nbody_tpu_torch/_build/``. The
library's file name carries a hash of the sources and the flags, so an edit
to either builds a new library and a stale one is never loaded.

Importing this module builds nothing; :func:`load_library` does, once per
process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / spills into the build log
)

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "nbody_precise_accel": ((_c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                             _c_int, _c_float, _c_int, _c_void_p), _c_int),
    "nbody_symmetric_forces": ((_c_void_p, _c_void_p, _c_int, _c_int,
                                _c_float, _c_int, _c_void_p), _c_int),
    "nbody_symmetric_block": ((), _c_int),
    "nbody_error_string": ((_c_int,), ctypes.c_char_p),
}


def sources() -> list[Path]:
    return sorted(p for p in SOURCE_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnbody_kernels_{h.hexdigest()[:16]}.so"


def build(lib: Path) -> None:
    """Compile every ``csrc/*.cu`` into ``lib``; the ptxas report goes to
    ``lib`` with suffix ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry points."""
    lib_path = library_path()
    if not lib_path.exists():
        build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(code: int, what: str) -> None:
    """Raise with the CUDA error string when a launch returned non-zero."""
    if code != 0:
        msg = load_library().nbody_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code}: {msg}")
