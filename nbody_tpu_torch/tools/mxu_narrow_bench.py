"""Product rates at the pair kernels' narrow shapes on the card.

Port of the repo's ``tools/mxu_narrow_bench.py``, which asked whether the
brute-force kernel's only product-shaped contractions could use the TPU's
MXU. Here the question is the same for Hopper's tensor cores and K5's
narrow products:

* (T, S) @ (S, 4): the weighted reduction (output axis 4 wide);
* its (S, 128) padded form;
* (T, D) @ (D, S): the d² dot (inner axis D ≤ 3, padded to 4);
* a 4096³ square control.

Each shape runs as a dependent chain of ``ITERS`` = 64 products timed with
CUDA events (the least of 3 runs after a warm-up run), through
``torch.matmul`` (the library measured here, as XLA's dot was there) in
bf16, in fp32 with TF32 off, and in TF32; and through P's hand-written fp32
product (``tools/microbench.matmul_probe``, Σ of the 64 products in one
launch), whose scale-normalized error against the f64 product (64 ·
a @ b, the plain version's sum) is recorded. Each row gives
ms and TFLOP/s (2·T·S·N·64 / time).

The chain: each product's output sum, scaled by 1e-8, is added to the
smaller operand before the next product, so no product can be elided or
run out of order. The JAX tool adds it to ``a``; at (4096, 16384) that add
moves as many bytes as the narrow product itself, so the port feeds the
smaller operand instead. Inputs: U(0, 1) from a generator on the card
seeded with 0. Needs the card: ``--device cpu`` exits 2.

    python -m nbody_tpu_torch.tools.mxu_narrow_bench [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..utils.accuracy import scale_normalized_error
from .common import RESULTS_DIR, card_line, device_or_none, time_ms, \
    write_record
from .microbench import matmul_probe

#: (T, S, N, label): the JAX tool's shapes.
SHAPES = (
    (4096, 16384, 4, "reduction shape (S,4)"),
    (4096, 16384, 128, "padded-out reduction (S,128)"),
    (4096, 4, 16384, "d2 dot trick (D~4 inner)"),
    (4096, 4096, 4096, "square control"),
)
#: The library's rows: (label, dtype, TF32 allowed).
LIBRARY_ROWS = (("bfloat16", torch.bfloat16, False),
                ("float32", torch.float32, False),
                ("tf32", torch.float32, True))
ITERS, REPS = 64, 3
TINY = 1e-8  # representable in bf16 (1e-30 is not)


def chain(a: torch.Tensor, b: torch.Tensor, iters: int = ITERS):
    """``iters`` dependent products a @ b (module docstring)."""
    feed_a = a.numel() <= b.numel()
    acc = torch.zeros((), dtype=a.dtype, device=a.device)
    for _ in range(iters):
        acc = acc + (a @ b).sum() * TINY
        if feed_a:
            a = a + acc * TINY
        else:
            b = b + acc * TINY
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.mxu_narrow_bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "mxu_narrow_bench.json"))
    args = ap.parse_args(argv)
    dev = device_or_none(args.device, "mxu_narrow_bench")
    if dev is None:
        return 2
    if dev.type != "cuda":
        print("mxu_narrow_bench: the rates are the card's", file=sys.stderr)
        return 2

    smi = card_line(dev)
    print(f"device={smi}")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for label, dtype, allow in LIBRARY_ROWS + (("P fp32", None, False),):
            torch.backends.cuda.matmul.allow_tf32 = allow
            for t, s, n, shape in SHAPES:
                a = torch.rand((t, s), generator=gen, device=dev)
                b = torch.rand((s, n), generator=gen, device=dev)
                row = {"route": label, "shape": [t, s, n], "what": shape}
                if dtype is None:
                    out, ms = time_ms(lambda: matmul_probe(a, b, ITERS), dev,
                                      reps=REPS)
                    row["err_vs_f64"] = float(scale_normalized_error(
                        out.double(), ITERS * (a.double() @ b.double())))
                else:
                    a, b = a.to(dtype), b.to(dtype)
                    _, ms = time_ms(lambda: chain(a, b), dev, reps=REPS)
                row.update(ms=ms, tflops=2.0 * t * s * n * ITERS / ms / 1e9)
                rows.append(row)
                print(f"  {label:9s} ({t:5d},{s:5d})@({s:5d},{n:5d}) "
                      f"[{shape:28s}] {ms:8.2f} ms  {row['tflops']:7.3f} "
                      f"TFLOP/s" + (f"  err vs f64 {row['err_vs_f64']:.2e}"
                                    if dtype is None else ""), flush=True)
                del a, b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    write_record(args.out, {"device": smi, "iters": ITERS, "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
