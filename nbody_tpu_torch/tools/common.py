"""What the port's command-line tools share: the device they run on, the
card's name and power limit, where their outputs go, how the probes time a
call and which failures a probe's sweep may record as a row's outcome."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Tuple

import torch

from ..ops.grid_tree import GridCapacityError

#: Default home of every tool's output, under the git-ignored ``results/``;
#: the JAX package's TPU records under ``artifacts/`` are never written.
RESULTS_DIR = os.path.join("results", "torch")


def device_or_none(name: str, tool: str) -> Optional[torch.device]:
    """``torch.device(name)``; None, after a message on stderr, where the
    card is asked for and no CUDA device is available (the tool then exits
    2, as the CLI does). The CPU runs only when asked for by name."""
    if name == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA device is available; the CPU runs only "
              f"when asked for (see --help)", file=sys.stderr)
        return None
    return torch.device(name)


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (the first one);
    ``"cpu"`` for a CPU run."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_once(fn: Callable, device: torch.device) -> Tuple[object, float]:
    """(``fn()``, its milliseconds): CUDA events around the call on the
    card; on the CPU the host's clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn: Callable, device: torch.device,
            reps: int = 1) -> Tuple[object, float]:
    """(the last result, the least of ``reps`` times in ms) after one
    warm-up call, which builds and loads the kernels and sizes the
    allocator's pool: the JAX tools' "cached (second) run", whose first run
    compiled."""
    fn()
    best, out = float("inf"), None
    for _ in range(reps):
        out, ms = time_once(fn, device)
        best = min(best, ms)
    return out, best


def parse_cases(spec: str) -> List[Tuple[int, int]]:
    """``"2000000:3,4000000:3"`` → [(2000000, 3), (4000000, 3)]."""
    cases = []
    for case in spec.split(","):
        n_s, d_s = case.split(":")
        cases.append((int(n_s), int(d_s)))
    return cases


def write_record(path: str, record) -> None:
    """``record`` as indented JSON at ``path`` (directories made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


#: What a probe's sweep records as a row's outcome, a finding at the size
#: it asked for: the card's memory running out and the uniform grid's
#: capacity refusal. Any other exception propagates.
ROW_FAILURES = (torch.OutOfMemoryError, GridCapacityError)


def row_failure(exc: BaseException) -> str:
    """A failed row's outcome, as printed and recorded."""
    return f"{type(exc).__name__}: {str(exc)[:200]}"
