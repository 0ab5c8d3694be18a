"""Find the benchmark's parts by name: one file each, no list to edit.

* ``BENCHMARK.json`` at the repository root: the cells and the metrics.
* ``configs/<name>.json``: a deployment (bodies, physics, time step).
* ``mixes/<name>.json``: what runs on it (method, its parameters, the
  integrator, warm-up steps, the force engine).
* ``workloads/<cell>.json``: a cell, naming a configuration and a mix, with
  its check (rows compared, each number's limit).
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader a
  metric, ``read(run) -> float | None`` over a :class:`benchmark.run.RunRecord`;
  ``None`` leaves the metric out of the result. A reader may also define
  ``snapshot() -> float``, a program counter the harness reads when the
  window opens and when it closes (``run.snapshots[name]``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spec(root: Path | None = None) -> dict:
    with open((root or ROOT) / "BENCHMARK.json") as f:
        return json.load(f)


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` (kind: configs, mixes or workloads)."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def reader(kind: str, name: str) -> ModuleType:
    """The reader module ``<kind>/<name>.py`` (kind: end_to_end or
    metrics), loaded from its file, so a name may hold dots."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def metrics_of(cell: str, section: str, bench: dict) -> list:
    """The entries of ``bench[section]`` that this cell reports: those whose
    ``workloads`` list it, or that have no such list."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def cell(name: str) -> tuple:
    """(cell, configuration, mix) of the cell ``name``."""
    c = load("workloads", name)
    return c, load("configs", c["config"]), load("mixes", c["mix"])
