// P: operation-rate probes of the card (the ceilings every kernel's bound
// divides by).
//
// Replaces tools/vpu_microbench.py's two Pallas probes: run_op's loop kernel
// (_loop_kernel, a fori_loop of one elementwise op over a VMEM-resident
// (256, 1024) block) and its skinny-matmul kernel (matkern, 64 repeats of a
// (512, 2048) @ (2048, K) product accumulated in fp32, K in {4, 128}).
//
// nbody_rate_probe: every element of the block is one register-resident
// value that goes through `iters` dependent applications of one op. A
// thread carries kProbeElems elements (bf16 pairs for the bf16 ops, which
// run packed as __nv_bfloat162, the way Hopper issues them) whose chains
// interleave: one unrolled step applies the op to each of them in turn. The
// count and the constants are runtime arguments, so nvcc cannot fold the
// chain; the body is unrolled kProbeUnroll times so loop overhead stays a
// small share of the issue slots.
// What bounded the FMA (cuobjdump -sass of the kernel before this one, on
// an H100): one dependent chain a thread, compiled as FFMA R8, R8, R4, R5
// with c and d hoisted into a register pair by one LDC.64, so every FFMA
// read three registers from the register banks (FMUL reads one register
// and a uniform register: FMUL R7, R7, UR7). The chain's next FFMA comes
// from the same warp only after the previous one's latency, so the
// operand-reuse cache could not supply c and d either, and the FMA ran
// well under the FMUL rate: 1.44e13 FFMA/s against 2.33e13 at 16,384
// iterations, 1.60e13 against 3.00e13 at 2^20. With kProbeElems chains a thread the
// FFMAs of one unrolled step are independent and issue back to back as
// FFMA R12, R12, R4.reuse, R5.reuse: c and d come from the reuse cache and
// only the chain's own register from a bank. The FMA then issues at the
// FMUL rate (3.13e13/s at 2^20 iterations); the other ops keep theirs
// (4 chains of 256 threads measured best of 2, 4 and 8 chains and of 128,
// 256 and 512 threads: 8 chains halved the MUFU and bf16 rates).
// What bounds it: the issue rate of the op's pipe (FP32: 128 lanes/clk/SM;
// MUFU: 16 lanes/clk/SM).
//
// nbody_matmul_probe: the skinny product as an SIMT GEMM whose tiles stay
// in shared memory, as the TPU kernel keeps A and B in VMEM for the whole
// launch. FP32 FFMA only: TF32 would be another result, and the TPU probe
// runs at HIGHEST. Every repeat does its own 2*M*S*K flops from shared
// memory; the repeats are never folded into one product.
// * K > 16 (the probe's 128): the output is cut into 32 x 128 tiles and S
//   into 256-wide slices; at (512, 2048) @ (2048, 128) that is 16 tiles x 8
//   slices = 128 CTAs of 256 threads, one an SM. A CTA stages its A slice
//   (32 KB, transposed) and B slice (128 KB) once with cp.async, then runs
//   all repeats from shared memory into 16 x 8 register micro-tiles: per k
//   four float4 loads of A (broadcast within each quarter-warp) and two of
//   B (128 contiguous bytes per quarter-warp) feed 128 FFMAs, 21 a load.
//   Its 8 k-groups' partials are summed in k-group order through shared
//   memory into the CTA's partial, stored to a workspace. Then a second,
//   small pass with a fixed order and no atomics: each output adds its 8
//   slices' partials in rank order. (Clusters of 8 slices summed through
//   distributed shared memory ran in two waves, the card holding fewer
//   than 16 such clusters at once; a cooperative launch adding the slices
//   into out one rank between two grid-wide barriers took ~25 us more on an
//   H100.)
// * K <= 16 (the probe's 4): a CTA owns 4 rows and 4 columns over all of
//   S, with B's stretch whole in shared memory beside the rows of A; at
//   K = 4 that is 128 CTAs; per k one float4 of each feeds 16 FFMAs.
// What bounds it: FP32 issue (67 TFLOP/s counts an FFMA as 2), with the
// shared-memory pipe (one 128-byte wavefront a clock) close behind at 16
// FFMA a float4 load on an SM of 128 FP32 lanes.
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
constexpr int kProbeElems = 4;  // a thread's interleaved chains

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

// Element e of CTA b's thread t is b * kProbeThreads * kProbeElems +
// e * kProbeThreads + t: each of a warp's loads and stores is contiguous.
template <typename T, typename Step>
__device__ __forceinline__ void probe_chains(T* __restrict__ x, int n,
                                             int iters, T fill, Step step) {
  const int base = blockIdx.x * kProbeThreads * kProbeElems + threadIdx.x;
  T v[kProbeElems];
#pragma unroll
  for (int e = 0; e < kProbeElems; ++e) {
    const int i = base + e * kProbeThreads;
    v[e] = i < n ? x[i] : fill;
  }
  int it = 0;
  for (; it + kProbeUnroll <= iters; it += kProbeUnroll) {
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < kProbeElems; ++e) v[e] = step(v[e]);
    }
  }
  for (; it < iters; ++it) {
#pragma unroll
    for (int e = 0; e < kProbeElems; ++e) v[e] = step(v[e]);
  }
#pragma unroll
  for (int e = 0; e < kProbeElems; ++e) {
    const int i = base + e * kProbeThreads;
    if (i < n) x[i] = v[e];
  }
}

template <int OP>
__global__ void __launch_bounds__(kProbeThreads)
rate_probe_f32(float* __restrict__ x, int n, int iters, float c, float d) {
  probe_chains(x, n, iters, 1.0f,
               [=](float v) { return f32_op<OP>(v, c, d); });
}

template <int OP>
__global__ void __launch_bounds__(kProbeThreads)
rate_probe_bf16(__nv_bfloat162* __restrict__ x, int npairs, int iters,
                float c, float d) {
  const __nv_bfloat162 c2 = __float2bfloat162_rn(c);
  const __nv_bfloat162 d2 = __float2bfloat162_rn(d);
  probe_chains(x, npairs, iters, __float2bfloat162_rn(1.0f),
               [=](__nv_bfloat162 v) { return bf16_op<OP>(v, c2, d2); });
}

constexpr int kProbeBlockElems = kProbeThreads * kProbeElems;

template <int OP>
void launch_f32(void* x, int n, int iters, float c, float d,
                cudaStream_t st) {
  const unsigned grid =
      (unsigned)((n + kProbeBlockElems - 1) / kProbeBlockElems);
  rate_probe_f32<OP><<<grid, kProbeThreads, 0, st>>>(
      static_cast<float*>(x), n, iters, c, d);
}

template <int OP>
void launch_bf16(void* x, int n, int iters, float c, float d,
                 cudaStream_t st) {
  const int npairs = n / 2;
  const unsigned grid =
      (unsigned)((npairs + kProbeBlockElems - 1) / kProbeBlockElems);
  rate_probe_bf16<OP><<<grid, kProbeThreads, 0, st>>>(
      static_cast<__nv_bfloat162*>(x), npairs, iters, c, d);
}

// The skinny product. cp.async of 4 bytes with zero fill: each staged
// element lands where its tile wants it (A transposed), and elements past
// an edge of A or B read as 0, so ragged shapes need no other branch.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wide product (kk > kMatNarrowMaxK). A CTA owns a kMatBM x kMatBN output
// tile and one kMatBK slice of S: kMatSlices CTAs, ranks 0.., take the
// slices of one tile (every kMatSlices-th slice past the first
// kMatSlices * kMatBK of S), each storing its partial to ws[rank][tile].
constexpr int kMatBM = 32;
constexpr int kMatBN = 128;
constexpr int kMatBK = 256;
constexpr int kMatSlices = 8;
constexpr int kMatThreads = 256;
constexpr int kMatTM = 16;  // rows of a thread's micro-tile; 8 columns
constexpr int kMatTY = kMatBM / kMatTM;                    // row groups
constexpr int kMatTX = kMatBN / 8;                         // column groups
constexpr int kMatKG = kMatThreads / (kMatTX * kMatTY);    // k-groups
constexpr int kMatKPer = kMatBK / kMatKG;                  // k of a group
constexpr int kMatRowStride = kMatBM * 4 / kMatTM;         // between quads
constexpr int kMatWideSmem = (kMatBK * kMatBM + kMatBK * kMatBN) * 4;
static_assert(kMatKG * kMatBM <= kMatBK && kMatBN <= kMatBK,
              "the reduction buffers fit in the staged tiles");

__global__ void __launch_bounds__(kMatThreads, 1)
matmul_wide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ ws, int m, int s, int kk, int reps) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // [kMatBK][kMatBM]
  float* bs = as + kMatBK * kMatBM;             // [kMatBK][kMatBN]
  const int tile = (int)blockIdx.x / kMatSlices;
  const int rank = (int)blockIdx.x % kMatSlices;
  const int tiles_n = (kk + kMatBN - 1) / kMatBN;
  const int tid = threadIdx.x;
  const int tx = tid % kMatTX;
  const int ty = (tid / kMatTX) % kMatTY;
  const int kg = tid / (kMatTX * kMatTY);
  const int m0 = tile / tiles_n * kMatBM;
  const int n0 = tile % tiles_n * kMatBN;
  float acc[kMatTM][8];
#pragma unroll
  for (int i = 0; i < kMatTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = rank * kMatBK; k0 < s; k0 += kMatSlices * kMatBK) {
    __syncthreads();
    for (int e = tid; e < kMatBM * kMatBK; e += kMatThreads) {
      const int r = e / kMatBK, c = e % kMatBK;  // coalesced along S
      const bool ok = m0 + r < m && k0 + c < s;
      cp_async_f32(as + c * kMatBM + r,
                   ok ? a + (long long)(m0 + r) * s + k0 + c : a, ok);
    }
    for (int e = tid; e < kMatBK * kMatBN; e += kMatThreads) {
      const int r = e / kMatBN, c = e % kMatBN;
      const bool ok = k0 + r < s && n0 + c < kk;
      cp_async_f32(bs + e, ok ? b + (long long)(k0 + r) * kk + n0 + c : b,
                   ok);
    }
    cp_async_wait_all();
    __syncthreads();
    // Every repeat is the whole product again, from shared memory: per k,
    // kMatTM / 4 + 2 float4 loads feed kMatTM * 8 FFMAs.
    const float* ak = as + kg * kMatKPer * kMatBM + ty * 4;
    const float* bk = bs + kg * kMatKPer * kMatBN + tx * 4;
    for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 4
      for (int q = 0; q < kMatKPer; ++q) {
        float av[kMatTM], bv[8];
#pragma unroll
        for (int h = 0; h < kMatTM / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              ak + q * kMatBM + h * kMatRowStride);
          av[4 * h] = v.x;
          av[4 * h + 1] = v.y;
          av[4 * h + 2] = v.z;
          av[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              bk + q * kMatBN + h * (kMatBN / 2));
          bv[4 * h] = v.x;
          bv[4 * h + 1] = v.y;
          bv[4 * h + 2] = v.z;
          bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < kMatTM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
  // The k-groups' partials (in B's tile), summed in k-group order into the
  // CTA's partial, ws[rank][tile].
  float* red = bs;  // [kMatKG][kMatBM][kMatBN]
#pragma unroll
  for (int i = 0; i < kMatTM; ++i) {
    const int row = (i / 4) * kMatRowStride + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(red + (kg * kMatBM + row) * kMatBN +
                                 h * (kMatBN / 2) + tx * 4) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  }
  __syncthreads();
  const int tiles = (int)gridDim.x / kMatSlices;
  float* part = ws + ((long long)rank * tiles + tile) * (kMatBM * kMatBN);
  for (int e = tid; e < kMatBM * kMatBN; e += kMatThreads) {
    float v = red[e];
    for (int g = 1; g < kMatKG; ++g) v += red[g * kMatBM * kMatBN + e];
    part[e] = v;
  }
}

// The second pass: out = the kMatSlices partials of each output's tile,
// added in rank order.
__global__ void __launch_bounds__(256)
matmul_slices_kernel(const float* __restrict__ ws, float* __restrict__ out,
                     int m, int kk, int tiles) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)m * kk) return;
  const int row = (int)(i / kk), col = (int)(i % kk);
  const int tiles_n = (kk + kMatBN - 1) / kMatBN;
  const long long e =
      (long long)(row / kMatBM * tiles_n + col / kMatBN) * (kMatBM * kMatBN) +
      (row % kMatBM) * kMatBN + col % kMatBN;
  const long long stride = (long long)tiles * (kMatBM * kMatBN);
  float v = ws[e];
  for (int r = 1; r < kMatSlices; ++r) v += ws[r * stride + e];
  out[i] = v;
}

// The wide product's workspace, [kMatSlices][tiles][kMatBM][kMatBN]: one
// buffer per device, grown as needed and kept for the process (cudaMalloc
// and cudaFree synchronize the device, so it is never freed under a kernel
// that reads it).
cudaError_t matmul_workspace(size_t bytes, float** ws) {
  constexpr int kMaxDevices = 64;
  static float* buf[kMaxDevices] = {};
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cap[dev] < bytes) {
    if (buf[dev] != nullptr && (err = cudaFree(buf[dev])) != cudaSuccess)
      return err;
    buf[dev] = nullptr;
    cap[dev] = 0;
    if ((err = cudaMalloc(&buf[dev], bytes)) != cudaSuccess) return err;
    cap[dev] = bytes;
  }
  *ws = buf[dev];
  return cudaSuccess;
}

// Narrow product (kk <= kMatNarrowMaxK; the probe's K = 4). A CTA owns
// kMatNR rows and kMatNC columns and walks all of S, kMatNS at a time, with
// that stretch of B whole in shared memory beside its rows of A. Thread t
// takes k = t, t + kMatNThreads, ... of the stretch: per k one float4 of A
// (its kMatNR rows) and one of B feed 16 FFMAs.
constexpr int kMatNarrowMaxK = 16;
constexpr int kMatNR = 4;
constexpr int kMatNC = 4;
constexpr int kMatNS = 2048;
constexpr int kMatNThreads = 256;
constexpr int kMatNarrowSmem = kMatNS * (kMatNR + kMatNC) * 4;
static_assert(kMatNR == 4 && kMatNC == 4, "one float4 of A and B per k");

__global__ void __launch_bounds__(kMatNThreads)
matmul_narrow_kernel(const float* __restrict__ a,
                     const float* __restrict__ b, float* __restrict__ out,
                     int m, int s, int kk, int reps) {
  extern __shared__ float4 smem4[];
  float4* as = smem4;           // [kMatNS]: rows m0..m0+3 at k
  float4* bs = smem4 + kMatNS;  // [kMatNS]: columns n0..n0+3 at k
  __shared__ float red[kMatNThreads / 32][kMatNR * kMatNC];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kMatNR;
  const int n0 = blockIdx.y * kMatNC;
  float acc[kMatNR][kMatNC];
#pragma unroll
  for (int i = 0; i < kMatNR; ++i)
#pragma unroll
    for (int j = 0; j < kMatNC; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < s; k0 += kMatNS) {
    __syncthreads();
    float* af = reinterpret_cast<float*>(as);
    float* bf = reinterpret_cast<float*>(bs);
    for (int e = tid; e < kMatNR * kMatNS; e += kMatNThreads) {
      const int r = e / kMatNS, c = e % kMatNS;
      const bool ok = m0 + r < m && k0 + c < s;
      cp_async_f32(af + c * kMatNR + r,
                   ok ? a + (long long)(m0 + r) * s + k0 + c : a, ok);
    }
    for (int e = tid; e < kMatNS * kMatNC; e += kMatNThreads) {
      const int r = e / kMatNC, c = e % kMatNC;
      const bool ok = k0 + r < s && n0 + c < kk;
      cp_async_f32(bf + e, ok ? b + (long long)(k0 + r) * kk + n0 + c : b,
                   ok);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
      for (int q = 0; q < kMatNS / kMatNThreads; ++q) {
        const float4 av = as[q * kMatNThreads + tid];
        const float4 bv = bs[q * kMatNThreads + tid];
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kMatNR; ++i)
#pragma unroll
          for (int j = 0; j < kMatNC; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
  }
  // Fixed order: a butterfly within each warp (every lane ends with the
  // same sum), then the warps in order.
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kMatNR; ++i)
#pragma unroll
    for (int j = 0; j < kMatNC; ++j) {
      float v = acc[i][j];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
      if (lane == 0) red[warp][i * kMatNC + j] = v;
    }
  __syncthreads();
  if (tid < kMatNR * kMatNC) {
    float v = red[0][tid];
    for (int w = 1; w < kMatNThreads / 32; ++w) v += red[w][tid];
    const int row = m0 + tid / kMatNC, col = n0 + tid % kMatNC;
    if (row < m && col < kk) out[(long long)row * kk + col] = v;
  }
}

// Raises a kernel's dynamic shared memory limit once per process.
template <class K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
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
  auto* af = static_cast<const float*>(a);
  auto* bf = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  static bool narrow_ready = false, wide_ready = false;
  if (kk <= kMatNarrowMaxK) {
    const cudaError_t err =
        allow_smem(matmul_narrow_kernel, kMatNarrowSmem, narrow_ready);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((m + kMatNR - 1) / kMatNR),
                    (unsigned)((kk + kMatNC - 1) / kMatNC));
    matmul_narrow_kernel<<<grid, kMatNThreads, kMatNarrowSmem, st>>>(
        af, bf, o, m, s, kk, reps);
  } else {
    cudaError_t err = allow_smem(matmul_wide_kernel, kMatWideSmem,
                                 wide_ready);
    if (err != cudaSuccess) return (int)err;
    const long long tiles =
        (long long)((m + kMatBM - 1) / kMatBM) * ((kk + kMatBN - 1) / kMatBN);
    if (tiles * kMatSlices > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    float* ws = nullptr;
    if ((err = matmul_workspace((size_t)tiles * kMatSlices * kMatBM * kMatBN *
                                    sizeof(float),
                                &ws)) != cudaSuccess)
      return (int)err;
    matmul_wide_kernel<<<(unsigned)(tiles * kMatSlices), kMatThreads,
                         kMatWideSmem, st>>>(af, bf, ws, m, s, kk, reps);
    const long long blocks = ((long long)m * kk + 255) / 256;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    matmul_slices_kernel<<<(unsigned)blocks, 256, 0, st>>>(ws, o, m, kk,
                                                           (int)tiles);
  }
  return (int)cudaGetLastError();
}
