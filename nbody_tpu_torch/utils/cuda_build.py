"""Build and load the port's CUDA kernels (``nbody_tpu_torch/csrc``).

The kernels have a plain C interface. ``nvcc`` compiles each ``csrc/*.cu``
into an object file, all sources at once in parallel processes, and links
the objects into one shared library, loaded with ``ctypes``. The build
happens at first use, from the sources in the package only, into
``nbody_tpu_torch/_build/``. The library's file name carries a hash of the
sources and the flags, so an edit to either builds a new library and a
stale one is never loaded.

Importing this module builds nothing; :func:`load_library` does, once per
process.

Each kernel's wrapper adds one to :data:`LAUNCHES` where it launches the
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / spills into the build log
)

#: Launches per kernel of the library since the process started (or a
#: caller reset them).
LAUNCHES = {"precise": 0, "symmetric": 0, "sym_tile": 0, "fused_steps": 0,
            "mxu": 0, "near_field": 0, "p2p_leaf": 0, "rate_probe": 0,
            "matmul_probe": 0, "near_field_occupied": 0}

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "nbody_precise_accel": ((_c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                             _c_int, _c_float, _c_int, _c_void_p), _c_int),
    "nbody_symmetric_forces": ((_c_void_p, _c_void_p, _c_int, _c_int,
                                _c_float, _c_int, _c_void_p), _c_int),
    "nbody_symmetric_block": ((), _c_int),
    "nbody_sym_tile": ((_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
                        _c_int, _c_int, _c_float, _c_int, _c_void_p), _c_int),
    "nbody_fused_steps": ((_c_void_p, _c_void_p, _c_int, _c_int, _c_int,
                           _c_float, _c_float, _c_float, _c_int, _c_int,
                           _c_void_p), _c_int),
    "nbody_fused_cluster_size": ((ctypes.POINTER(_c_int),), _c_int),
    "nbody_fused_force_cluster": ((_c_int,), _c_int),
    "nbody_mxu_accel": ((_c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                         _c_int, _c_int, _c_float, _c_void_p), _c_int),
    "nbody_near_field": ((_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
                          _c_int, _c_int, _c_int, _c_int, _c_float,
                          _c_void_p), _c_int),
    "nbody_near_field_occupied": ((_c_void_p, _c_void_p, _c_void_p,
                                   _c_void_p, _c_void_p, _c_void_p, _c_int,
                                   _c_int, _c_int, ctypes.c_longlong,
                                   _c_float, _c_void_p), _c_int),
    "nbody_p2p_leaf": ((_c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                        _c_int, _c_int, _c_float, _c_void_p), _c_int),
    "nbody_rate_probe": ((_c_void_p, _c_int, _c_int, _c_int, _c_float,
                          _c_float, _c_void_p), _c_int),
    "nbody_matmul_probe": ((_c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                            _c_int, _c_int, _c_void_p), _c_int),
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
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started together)
    and link them into ``lib``; the ptxas reports go to ``lib`` with suffix
    ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out[-4000:]}")
        so = os.path.join(tmp, lib.name)
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                 *(obj for _, obj, _ in procs)],
                capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n"
                              f"{link.stderr[-4000:]}")
        lib.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(so, lib)  # atomic: a concurrent loader never sees half


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


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) of a build log: the registers, spill
    stores and loads and static shared memory (bytes) that ``ptxas -v``
    reported."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(m.group(1)) if m else 0
    return out


def kernel_label(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel name of this library,
    e.g. ``newton3_kernel<2,0,1>`` (int and bool template arguments)."""
    m = re.search(r"N5nbody\d+(\w+?)I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def check(code: int, what: str) -> None:
    """Raise with the CUDA error string when a launch returned non-zero."""
    if code != 0:
        msg = load_library().nbody_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code}: {msg}")
