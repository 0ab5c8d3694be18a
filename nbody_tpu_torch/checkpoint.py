"""Checkpoint / resume for simulation state, npz format.

Port of the npz branch of ``nbody_tpu.checkpoint``: the same
``<dir>/step_<k>.npz`` layout and keys (``positions``, ``velocities``,
``masses``, ``step`` and optional ``key``), so files load across the two
packages in both directions. ``key`` is kept as an opaque uint32 array (the
JAX package stores ``jax.random.key_data`` there).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

from .state import System, system_from_numpy


def save_checkpoint(directory: str, system: System, step: int,
                    key: Optional[np.ndarray] = None) -> str:
    """Persist (system, step, key); returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.npz")
    positions, velocities, masses = system.to_numpy()
    payload = {"positions": positions, "velocities": velocities,
               "masses": masses, "step": np.asarray(step, np.int64)}
    if key is not None:
        payload["key"] = np.asarray(key, np.uint32)
    np.savez(path, **payload)
    return path


def latest_step(directory: str) -> Optional[int]:
    """Highest checkpointed step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)\.npz", name))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None, *, device
                    ) -> Tuple[System, int, Optional[np.ndarray]]:
    """Restore (system on ``device``, step, key or None)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint for step {step} in {directory}")
    with np.load(path) as data:
        system = system_from_numpy(data["positions"], data["velocities"],
                                   data["masses"], device)
        key = np.asarray(data["key"], np.uint32) if "key" in data else None
        return system, int(data["step"]), key
