"""Operation-rate probes of the card (P), through ``csrc/rate_probe.cu``.

    python -m nbody_tpu_torch.tools.microbench [--iters 1048576] [--reps 64]

Port of ``tools/vpu_microbench.py``. It measures the rates that bound every
pair kernel of the port: each op of the TPU tool (f32 mul, FMA, add, rsqrt,
rsqrt³, approximate reciprocal, select; bf16 mul and FMA; bf16 rsqrt through
f32) as a dependent loop on a register-resident (256, 1024) block, and the
skinny (512, 2048) @ (2048, K) products, K ∈ {4, 128}, of the force
reduction, repeated 64 times, as a hand-written fp32 SIMT GEMM whose tiles
stay in shared memory for all the repeats. Beside the latter it times
``torch.matmul`` at the same shapes with TF32 off and on: the library's
yardstick, used nowhere in the port.

Every probe has its plain version in torch beside it (the same loop, for a
small block and a few iterations). The wrappers run the plain version for
CPU tensors and launch the kernel for CUDA tensors; each launch adds one to
``cuda_build.LAUNCHES["rate_probe"]`` or ``["matmul_probe"]``. Rates are
printed with the card's name; without a card the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ..ops.cuda_brute import _stream
from ..utils import cuda_build
from ..utils.cuda_build import LAUNCHES

BLOCK = (256, 1024)
MATMUL_SHAPE = (512, 2048)
MATMUL_KS = (4, 128)
MATMUL_REPS = 64

# The TPU tool's constants (tools/vpu_microbench.py:64-88).
C32, D32 = 1.0000001, 1e-7
C16, D16 = 1.001, 0.001


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    code: int  # ProbeOp in csrc/rate_probe.cu
    dtype: torch.dtype
    c: float
    d: float


# In the kernel's op order.
OPS = (
    Op("f32 mul", 0, torch.float32, C32, 0.0),
    Op("f32 fma", 1, torch.float32, C32, D32),
    Op("f32 add", 2, torch.float32, 0.0, D32),
    Op("f32 rsqrt", 3, torch.float32, 0.0, 0.0),
    Op("f32 rsqrt+cube (u*u*u)", 4, torch.float32, 0.0, 0.0),
    Op("f32 reciprocal(approx)", 5, torch.float32, 1.0, 0.0),
    Op("f32 where(x<c, 0, x)", 6, torch.float32, 0.5, D32),
    Op("bf16 mul", 7, torch.bfloat16, C16, 0.0),
    Op("bf16 fma", 8, torch.bfloat16, C16, D16),
    Op("bf16 rsqrt via f32", 9, torch.bfloat16, 0.0, 0.0),
)
OPS_BY_NAME = {op.name: op for op in OPS}


def _step_plain(op: Op, x: torch.Tensor) -> torch.Tensor:
    """One application of ``op``, rounding as the kernel does."""
    if op.dtype == torch.bfloat16:
        c = torch.tensor(op.c, dtype=torch.bfloat16).float()
        d = torch.tensor(op.d, dtype=torch.bfloat16).float()
        f = x.float()
        if op.code == 7:
            y = f * c
        elif op.code == 8:
            y = (f.double() * c.double() + d.double()).float()
        else:
            y = torch.rsqrt(f)
        return y.to(torch.bfloat16)
    if op.code == 0:
        return x * op.c
    if op.code == 1:  # one rounding, as fmaf
        return (x.double() * torch.tensor(op.c, dtype=torch.float32).double()
                + torch.tensor(op.d, dtype=torch.float32).double()).float()
    if op.code == 2:
        return x + op.d
    if op.code == 3:
        return torch.rsqrt(x)
    if op.code == 4:
        u = torch.rsqrt(x)
        return u * u * u
    if op.code == 5:  # times c = 1, which keeps the kernel's chain whole
        return (1.0 / x) * op.c
    return torch.where(x < op.c, torch.zeros_like(x), x) + op.d


def rate_probe_plain(op: Op, x: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of the loop kernel: ``iters`` applications of ``op``."""
    for _ in range(iters):
        x = _step_plain(op, x)
    return x


def rate_probe(op: Op, x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` dependent applications of ``op`` to every element of ``x``
    (``op.dtype``; an even count for bf16): the kernel on a CUDA tensor
    (a new tensor, ``x`` is left as it was), the plain version on a CPU one."""
    if x.dtype != op.dtype:
        raise ValueError(f"{op.name} takes {op.dtype}, got {x.dtype}")
    if x.device.type == "cpu":
        return rate_probe_plain(op, x, iters)
    out = x.contiguous().clone()
    code = cuda_build.load_library().nbody_rate_probe(
        out.data_ptr(), out.numel(), op.code, int(iters), float(op.c),
        float(op.d), _stream())
    cuda_build.check(code, f"rate_probe kernel ({op.name})")
    LAUNCHES["rate_probe"] += 1
    return out


def matmul_probe_plain(a: torch.Tensor, b: torch.Tensor,
                       reps: int) -> torch.Tensor:
    """Plain version of the matmul probe: ``reps`` products added up in
    fp32 (the caller keeps TF32 off on the card)."""
    acc = a.new_zeros((a.shape[0], b.shape[1]))
    for _ in range(reps):
        acc = acc + a @ b
    return acc


def matmul_probe(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Σ over ``reps`` of a @ b in fp32: the SIMT GEMM on CUDA tensors (its
    fp32 sums in a fixed order, so the result is deterministic), the plain
    version on CPU ones."""
    if a.dtype != torch.float32 or b.dtype != torch.float32 or \
            a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_probe takes fp32 [M, S] @ [S, K], got "
                         f"{tuple(a.shape)} {a.dtype} @ {tuple(b.shape)} "
                         f"{b.dtype}")
    if a.device.type == "cpu":
        return matmul_probe_plain(a, b, reps)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    code = cuda_build.load_library().nbody_matmul_probe(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1],
        b.shape[1], int(reps), _stream())
    cuda_build.check(code, "matmul_probe kernel")
    LAUNCHES["matmul_probe"] += 1
    return out


def _event_ms(fn) -> float:
    """CUDA-event time of one ``fn()`` after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run(iters: int = 1 << 20, reps: int = MATMUL_REPS, device="cuda",
        log=print) -> dict:
    """Time every probe on ``device`` (a CUDA device) and return
    {"ops": {name: {"ms", "rate"}}, "matmul": {K: {...}}}; ``rate`` is
    element-ops per second for the loop kernel, FLOP/s for the products."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the rate probes measure a CUDA device")
    res = {"ops": {}, "matmul": {}}
    n = BLOCK[0] * BLOCK[1]
    for op in OPS:
        x = torch.full(BLOCK, 1.5, dtype=op.dtype, device=device)
        ms = _event_ms(lambda: rate_probe(op, x, iters))
        rate = n * iters / (ms * 1e-3)
        res["ops"][op.name] = {"ms": ms, "rate": rate}
        log(f"{op.name:34s} {ms:9.3f} ms   {rate / 1e12:7.3f} Tops/s")
    m, s = MATMUL_SHAPE
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for kk in MATMUL_KS:
            a = torch.full((m, s), 0.001, dtype=torch.float32, device=device)
            b = torch.full((s, kk), 0.001, dtype=torch.float32,
                           device=device)
            flops = 2 * m * s * kk * reps
            # The library's one call for the same sum: the reps copies laid
            # end to end along the reduction axis (built outside the timing).
            a_rep, b_rep = a.repeat(1, reps), b.repeat(reps, 1)
            torch.backends.cuda.matmul.allow_tf32 = False
            row = {"kernel_ms": _event_ms(lambda: matmul_probe(a, b, reps)),
                   "plain_ms": _event_ms(
                       lambda: matmul_probe_plain(a, b, reps))}
            for label, allow in (("matmul_ms", False),
                                 ("matmul_tf32_ms", True)):
                torch.backends.cuda.matmul.allow_tf32 = allow
                row[label] = _event_ms(lambda: torch.matmul(a_rep, b_rep))
            torch.backends.cuda.matmul.allow_tf32 = False
            del a_rep, b_rep
            for key in ("kernel_ms", "plain_ms", "matmul_ms",
                        "matmul_tf32_ms"):
                row[key.replace("_ms", "_tflops")] = \
                    flops / (row[key] * 1e-3) / 1e12
            res["matmul"][kk] = row
            log(f"matmul ({m},{s})@({s},{kk:3d}) x{reps}: SIMT kernel "
                f"{row['kernel_ms']:8.3f} ms {row['kernel_tflops']:7.3f} "
                f"TFLOP/s; plain loop {row['plain_ms']:8.3f} ms; one "
                f"torch.matmul fp32 {row['matmul_ms']:8.3f} ms "
                f"{row['matmul_tflops']:7.3f}, TF32 "
                f"{row['matmul_tf32_ms']:8.3f} ms "
                f"{row['matmul_tf32_tflops']:7.3f}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbody_tpu_torch.tools.microbench")
    ap.add_argument("--iters", type=int, default=1 << 20,
                    help="dependent applications per element")
    ap.add_argument("--reps", type=int, default=MATMUL_REPS,
                    help="repeats of each skinny product")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench: no CUDA device; the rates are the card's",
              file=sys.stderr)
        return 1
    print(f"device={torch.cuda.get_device_name(0)}  block={BLOCK}  "
          f"iters={args.iters}")
    run(args.iters, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
