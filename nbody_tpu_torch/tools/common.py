"""What the port's command-line tools share: the device they run on, the
card's name and power limit, and where their outputs go."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional

import torch

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
