"""The segmented brute force on the card: a check and, with ``--big``, times.

Port of the repo's ``tools/segmented_probe.py``. At ``CHECK_N`` = 3e5 2D,
``brute_force_cuda_segmented(num_segments=3)`` (K1 on each segment's own
pairs, K3 on each pair of segments) must match one K1 launch
(``brute_force_cuda(mode="symmetric")``) to fp32 rounding, and 5 segments
must match 3: both scale-normalized errors under 3e-4, the JAX tool's
asserts (the segmented driver adds each body's force in another order, so
~1e-4 is rounding; a double count or a sign error is O(1)). With ``--big``
it times the segmented driver at its default segment count at 2e6 and 5e6
2D, the reference's CUDA row sizes. Times: CUDA events, one call after a
warm-up call.

Bodies: the reference distribution from ``torch.Generator().manual_seed(3)``
(``--big``: seed 4).

    python -m nbody_tpu_torch.tools.segmented_probe [--big] [--device cpu]
        [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import GravityConfig
from ..ops.cuda_brute import (SEGMENT_ROWS, brute_force_cuda,
                              brute_force_cuda_segmented)
from ..state import random_system
from ..utils.accuracy import scale_normalized_error
from .common import RESULTS_DIR, card_line, device_or_none, time_ms, \
    write_record

CHECK_N = 300_000
BIG_N = (2_000_000, 5_000_000)
TOL = 3e-4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.segmented_probe")
    ap.add_argument("--big", action="store_true",
                    help="also time the 2e6/5e6 2D segmented path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "segmented_probe.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "segmented_probe")
    if dev is None:
        return 2
    cfg = GravityConfig()
    smi = card_line(dev)
    print("device:", smi)
    record = {"device": smi, "n": CHECK_N}

    s = random_system(CHECK_N, 2, generator=torch.Generator().manual_seed(3),
                      device=dev)
    ref, t_ref = time_ms(lambda: brute_force_cuda(
        s.positions, s.masses, cfg, mode="symmetric"), dev)
    seg, t_seg = time_ms(lambda: brute_force_cuda_segmented(
        s.positions, s.masses, cfg, num_segments=3), dev)
    err = float(scale_normalized_error(seg, ref))
    print(f"N={CHECK_N} 2D: symmetric {t_ref / 1e3:.3f}s, segmented(3) "
          f"{t_seg / 1e3:.3f}s, err {err:.2e}")
    seg5 = brute_force_cuda_segmented(s.positions, s.masses, cfg,
                                      num_segments=5)
    err35 = float(scale_normalized_error(seg5, seg))
    print(f"N={CHECK_N} 2D: segmented(5) vs segmented(3) err {err35:.2e}")
    record.update(symmetric_s=t_ref / 1e3, segmented3_s=t_seg / 1e3,
                  err_seg3_vs_symmetric=err, err_seg5_vs_seg3=err35)
    write_record(args.out, record)
    if not err < TOL:
        raise AssertionError(f"segmented(3) vs symmetric: {err}")
    if not err35 < TOL:
        raise AssertionError(f"segmented(5) vs segmented(3): {err35}")
    del s, ref, seg, seg5

    if args.big:
        record["big"] = []
        for n in BIG_N:
            b = random_system(n, 2, generator=torch.Generator().manual_seed(4),
                              device=dev)
            out, ms = time_ms(lambda: brute_force_cuda_segmented(
                b.positions, b.masses, cfg), dev)
            chk = float(out.abs().sum())
            segs = -(-n // SEGMENT_ROWS)
            print(f"N={n} 2D: segmented({segs}) {ms / 1e3:.2f}s "
                  f"(checksum {chk:.3e})")
            record["big"].append({"n": n, "segments": segs, "s": ms / 1e3,
                                  "checksum": chk})
            del b, out
        write_record(args.out, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
