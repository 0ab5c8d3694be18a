// P: operation-rate probes of the card (the ceilings every kernel's bound
// divides by).
//
// Replaces tools/vpu_microbench.py's two Pallas probes: run_op's loop kernel
// (_loop_kernel, a fori_loop of one elementwise op over a VMEM-resident
// (256, 1024) block) and its skinny-matmul kernel (matkern, 64 repeats of a
// (512, 2048) @ (2048, K) product accumulated in fp32, K in {4, 128}).
//
// nbody_rate_probe: every element of the block is one register-resident
// value that goes through `iters` dependent applications of one op. One
// thread per element (per bf16 pair for the bf16 ops, which run packed as
// __nv_bfloat162, the way Hopper issues them). The count and the constants
// are runtime arguments, so nvcc cannot fold the chain; the body is unrolled
// 32 times so loop overhead stays a small share of the issue slots. 262,144
// threads put ~62 warps on each of 132 SMs, enough to cover the latency of
// one dependent chain per thread. What bounds it: the issue rate of the op's
// pipe (FP32: 128 lanes/clk/SM; MUFU: 16 lanes/clk/SM).
//
// nbody_matmul_probe: the skinny product as a plain fp32 SIMT loop. A CTA
// owns 32 consecutive outputs (row-major over the [M, K] result, one per
// lane) and its 8 warps split the reduction axis; every repeat forms the
// dot product anew in fp32 FMAs and adds it to a per-warp total, and the
// warps' totals are summed in warp order through shared memory. What bounds
// it: load issue (two L1/L2 loads per FMA), far below the FP32 ceiling; the
// tensor cores are not used. It is the hand-written yardstick beside
// torch.matmul, which the probe tool times as the library's.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nbody {

enum ProbeOp {
  kF32Mul = 0,
  kF32Fma = 1,
  kF32Add = 2,
  kF32Rsqrt = 3,
  kF32RsqrtCube = 4,
  kF32RcpApprox = 5,
  kF32Select = 6,
  kBf16Mul = 7,
  kBf16Fma = 8,
  kBf16RsqrtViaF32 = 9,
  kNumProbeOps = 10,
};

constexpr int kProbeThreads = 256;
constexpr int kProbeUnroll = 32;

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int OP>
__device__ __forceinline__ float f32_op(float x, float c, float d) {
  if (OP == kF32Mul) return x * c;
  if (OP == kF32Fma) return fmaf(x, c, d);
  if (OP == kF32Add) return x + d;
  if (OP == kF32Rsqrt) return rsqrtf(x);
  if (OP == kF32RsqrtCube) {
    const float u = rsqrtf(x);
    return u * u * u;
  }
  // Times the runtime c = 1: without it the chain read 7.65e14 ops/s on an
  // H100, i.e. the compiler took rcp(rcp(x)) apart.
  if (OP == kF32RcpApprox) return rcp_approx(x) * c;
  return (x < c ? 0.0f : x) + d;  // kF32Select
}

template <int OP>
__device__ __forceinline__ __nv_bfloat162 bf16_op(__nv_bfloat162 x,
                                                  __nv_bfloat162 c,
                                                  __nv_bfloat162 d) {
  if (OP == kBf16Mul) return __hmul2(x, c);
  if (OP == kBf16Fma) return __hfma2(x, c, d);
  // kBf16RsqrtViaF32: Hopper, like the TPU, has no bf16 rsqrt.
  const float2 f = __bfloat1622float2(x);
  return __floats2bfloat162_rn(rsqrtf(f.x), rsqrtf(f.y));
}

template <int OP>
__global__ void __launch_bounds__(kProbeThreads)
rate_probe_f32(float* __restrict__ x, int n, int iters, float c, float d) {
  const int i = blockIdx.x * kProbeThreads + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  int it = 0;
  for (; it + kProbeUnroll <= iters; it += kProbeUnroll) {
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) v = f32_op<OP>(v, c, d);
  }
  for (; it < iters; ++it) v = f32_op<OP>(v, c, d);
  x[i] = v;
}

template <int OP>
__global__ void __launch_bounds__(kProbeThreads)
rate_probe_bf16(__nv_bfloat162* __restrict__ x, int npairs, int iters,
                float c, float d) {
  const int i = blockIdx.x * kProbeThreads + threadIdx.x;
  if (i >= npairs) return;
  const __nv_bfloat162 c2 = __float2bfloat162_rn(c);
  const __nv_bfloat162 d2 = __float2bfloat162_rn(d);
  __nv_bfloat162 v = x[i];
  int it = 0;
  for (; it + kProbeUnroll <= iters; it += kProbeUnroll) {
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) v = bf16_op<OP>(v, c2, d2);
  }
  for (; it < iters; ++it) v = bf16_op<OP>(v, c2, d2);
  x[i] = v;
}

template <int OP>
void launch_f32(void* x, int n, int iters, float c, float d,
                cudaStream_t st) {
  const unsigned grid = (unsigned)((n + kProbeThreads - 1) / kProbeThreads);
  rate_probe_f32<OP><<<grid, kProbeThreads, 0, st>>>(
      static_cast<float*>(x), n, iters, c, d);
}

template <int OP>
void launch_bf16(void* x, int n, int iters, float c, float d,
                 cudaStream_t st) {
  const int npairs = n / 2;
  const unsigned grid =
      (unsigned)((npairs + kProbeThreads - 1) / kProbeThreads);
  rate_probe_bf16<OP><<<grid, kProbeThreads, 0, st>>>(
      static_cast<__nv_bfloat162*>(x), npairs, iters, c, d);
}

constexpr int kMatWarps = 8;

__global__ void __launch_bounds__(kMatWarps * 32)
matmul_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int m, int s, int kk, int reps) {
  __shared__ float part[kMatWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long o = (long long)blockIdx.x * 32 + lane;
  const bool live = o < (long long)m * kk;
  const int i = live ? (int)(o / kk) : 0;
  const int j = live ? (int)(o % kk) : 0;
  const int per = (s + kMatWarps - 1) / kMatWarps;
  const int k0 = warp * per;
  const int k1 = min(s, k0 + per);
  const float* arow = a + (long long)i * s;
  float total = 0.0f;
  for (int r = 0; r < reps; ++r) {
    float dot = 0.0f;
    for (int k = k0; k < k1; ++k) dot = fmaf(arow[k], b[(long long)k * kk + j], dot);
    total += dot;
  }
  part[warp][lane] = total;
  __syncthreads();
  if (warp == 0 && live) {
    float sum = 0.0f;
    for (int w = 0; w < kMatWarps; ++w) sum += part[w][lane];
    out[o] = sum;
  }
}

}  // namespace nbody

// x: [n] f32 for ops 0-6, [n] bf16 (n even) for ops 7-9, updated in place
// by `iters` applications of op with constants c, d. Returns
// cudaGetLastError() after the launch.
extern "C" int nbody_rate_probe(void* x, int n, int op, int iters, float c,
                                float d, void* stream) {
  using namespace nbody;
  if (n <= 0 || iters < 0 || op < 0 || op >= kNumProbeOps ||
      (op >= kBf16Mul && n % 2 != 0))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kF32Mul: launch_f32<kF32Mul>(x, n, iters, c, d, st); break;
    case kF32Fma: launch_f32<kF32Fma>(x, n, iters, c, d, st); break;
    case kF32Add: launch_f32<kF32Add>(x, n, iters, c, d, st); break;
    case kF32Rsqrt: launch_f32<kF32Rsqrt>(x, n, iters, c, d, st); break;
    case kF32RsqrtCube:
      launch_f32<kF32RsqrtCube>(x, n, iters, c, d, st);
      break;
    case kF32RcpApprox:
      launch_f32<kF32RcpApprox>(x, n, iters, c, d, st);
      break;
    case kF32Select: launch_f32<kF32Select>(x, n, iters, c, d, st); break;
    case kBf16Mul: launch_bf16<kBf16Mul>(x, n, iters, c, d, st); break;
    case kBf16Fma: launch_bf16<kBf16Fma>(x, n, iters, c, d, st); break;
    default: launch_bf16<kBf16RsqrtViaF32>(x, n, iters, c, d, st); break;
  }
  return (int)cudaGetLastError();
}

// a: [m, s] f32, b: [s, kk] f32, out: [m, kk] f32 = sum over reps of a @ b,
// fully written. Returns cudaGetLastError() after the launch.
extern "C" int nbody_matmul_probe(const void* a, const void* b, void* out,
                                  int m, int s, int kk, int reps,
                                  void* stream) {
  using namespace nbody;
  if (m <= 0 || s <= 0 || kk <= 0 || reps < 0) return cudaErrorInvalidValue;
  const long long outs = (long long)m * kk;
  const unsigned grid = (unsigned)((outs + 31) / 32);
  matmul_probe_kernel<<<grid, kMatWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m, s, kk, reps);
  return (int)cudaGetLastError();
}
