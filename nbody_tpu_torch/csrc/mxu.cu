// K5: one-sided tile in the block-centred "matmul" form.
//
// Replaces ops/pallas_brute.py:_kernel_mxu (built by _tile_call in mode
// "mxu"). For each block of block_t targets, with c the block's FIRST
// target, it forms
//     a[t] = sum_s u3(t, s) * [m_s(x_s - c), m_s(y_s - c), m_s(z_s - c), m_s]
// and returns contrib[t] = a[t][:D] - (x_t - c) * a[t][D], not scaled by G.
// The guard is always on, on the UNSOFTENED d2 (d2 < 1e-10 -> u3 = 0): in
// this form the huge softened self weight meets no cancelling zero
// difference. block_t is semantic: the kernel centres on the same blocks as
// the JAX kernel. The centred sources are m*(x - c), computed once per source
// per CTA when the source is staged; the JAX kernel forms m*x - c*m
// (pallas_brute.py:291), which rounds at |m*x| instead of |m*(x - c)|.
//
// What differs from the TPU. There the (T, S) u3 tile is reduced by one
// full-fp32 MXU matmul (Precision.HIGHEST; bf16 inputs lost the
// cancellation-sensitive sum). Here the same reduction runs as fp32 FMAs on
// the CUDA cores, in fp32 chains of kChain sources into fp64 totals (as K2);
// the correction is applied in fp64 and rounded once. TF32 tensor-core input
// would keep about 3 digits, the bf16-class error the JAX kernel avoided; a
// 3xTF32 or wgmma version is later perf work.
//
// Design: one CTA per target block, block_t threads, one target each. The
// sources stream through shared memory in tiles of kMxuTile bodies, raw
// (for d2) and centred (for the reduction), read as broadcasts.
//
// What bounds it on Hopper: issue rate, as K2: about 10 (2D) to 13 (3D)
// FP32 instructions and one MUFU rsqrt per pair; blocks of 128-256 threads
// give enough CTAs to fill the card at large N.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include "pair_law.cuh"

namespace nbody {

constexpr int kMxuTile = 256;
constexpr int kMxuMaxBlock = 1024;

template <int DIM>
__global__ void __launch_bounds__(kMxuMaxBlock)
mxu_accel_kernel(const float4* __restrict__ tgt,
                 const float4* __restrict__ src, float4* __restrict__ out,
                 int t, int s, float soft2) {
  __shared__ float4 raw[kMxuTile];
  __shared__ float4 cen[kMxuTile];
  const long long i0 = (long long)blockIdx.x * blockDim.x;
  const long long i = i0 + threadIdx.x;
  const float4 c = tgt[i0];
  const float4 p = i < t ? tgt[i] : pad_body();
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;

  for (long long s0 = 0; s0 < s; s0 += kMxuTile) {
    for (int k = threadIdx.x; k < kMxuTile; k += blockDim.x) {
      const long long j = s0 + k;
      const float4 q = j < s ? src[j] : pad_body();
      raw[k] = q;
      cen[k] = make_float4(q.w * (q.x - c.x), q.w * (q.y - c.y),
                           DIM == 3 ? q.w * (q.z - c.z) : 0.0f, q.w);
    }
    __syncthreads();
    for (int k0 = 0; k0 < kMxuTile; k0 += kChain) {
      float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
#pragma unroll
      for (int k = k0; k < k0 + kChain; ++k) {
        const float4 q = raw[k];
        const float dx = q.x - p.x;
        const float dy = q.y - p.y;
        float d2 = dx * dx;
        d2 = fmaf(dy, dy, d2);
        if (DIM == 3) {
          const float dz = q.z - p.z;
          d2 = fmaf(dz, dz, d2);
        }
        const float u = rsqrtf(d2 + soft2);
        const float u3 = d2 < kDist2Guard ? 0.0f : u * u * u;
        const float4 e = cen[k];
        b0 = fmaf(u3, e.x, b0);
        b1 = fmaf(u3, e.y, b1);
        if (DIM == 3) b2 = fmaf(u3, e.z, b2);
        b3 = fmaf(u3, e.w, b3);
      }
      a0 += b0;
      a1 += b1;
      if (DIM == 3) a2 += b2;
      a3 += b3;
    }
    __syncthreads();
  }
  if (i < t) {
    const float cx = (float)(a0 - (double)(p.x - c.x) * a3);
    const float cy = (float)(a1 - (double)(p.y - c.y) * a3);
    const float cz = DIM == 3 ? (float)(a2 - (double)(p.z - c.z) * a3) : 0.0f;
    out[i] = make_float4(cx, cy, cz, 0.0f);
  }
}

}  // namespace nbody

// tgt: [t, 4] f32 (x, y, z|0, 0); src: [s, 4] f32 (x, y, z|0, m); out:
// [t, 4] f32, fully written. block_t in [1, 1024] targets per centring
// block (and per CTA). Returns cudaGetLastError().
extern "C" int nbody_mxu_accel(const void* tgt, const void* src, void* out,
                               int t, int s, int dim, int block_t,
                               float soft2, void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || t <= 0 || s < 0 || block_t <= 0 ||
      block_t > kMxuMaxBlock) {
    return cudaErrorInvalidValue;
  }
  auto* tg = static_cast<const float4*>(tgt);
  auto* sr = static_cast<const float4*>(src);
  auto* o = static_cast<float4*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((t + block_t - 1) / block_t);
  if (dim == 2) {
    mxu_accel_kernel<2><<<grid, block_t, 0, st>>>(tg, sr, o, t, s, soft2);
  } else {
    mxu_accel_kernel<3><<<grid, block_t, 0, st>>>(tg, sr, o, t, s, soft2);
  }
  return (int)cudaGetLastError();
}
