// The Newton-3 tile engine of K1 (symmetric.cu) and K3 (sym_tile.cu).
//
// One device routine sweeps an off-diagonal block pair: a target block of
// kN3Block bodies against a DISJOINT source block of kN3Block bodies, every
// (target, source) pair once, and returns both sides
//     acc_t[t]  +=  c_t * sum_s m_s * u3(t, s) * Delta,   Delta = x_s - x_t,
//     acc_s[s]  += -c_s * sum_t m_t * u3(t, s) * Delta,
// into fp64 device memory by atomicAdd. K3 (SYM = false) takes c = 1, its
// acceleration units. K1 (SYM = true) takes c = the body's own mass, so each
// side is the force / G with the weight w = m_t * m_s * u3; the masses
// multiply the fp64 totals once instead of every pair, as K1's plain version
// does. The weights cost two FMUL per pair either way. The kernel walks the
// strict lower triangle of block pairs for K1 (its diagonal blocks are a
// kernel of their own, symmetric.cu) and the whole rectangle for K3.
//
// What bounds it on Hopper: issue, not bytes. A pair is 12 (2D) or 16 (3D)
// FP32 instructions (differences, d2, u*u*u, two weights, both sides' FMAs)
// and one MUFU.RSQ, which takes a quarter of the FP32 rate; the rsqrt is the
// ftz form (pair_law.cuh), which drops the denormal fix-up around MUFU.RSQ.
// Device memory traffic is 32 bytes per body per block pair in, 2*DIM fp64
// atomics per body per block pair out.
//
// Design, per CTA of kN3Warps warps and one block pair:
//   * targets: each lane owns kN3R targets in registers (lane-strided, so
//     the loads coalesce), with fp32 chains of kChain = 32 sources, each
//     chain's total added into an fp64 register total (pair_law.cuh);
//   * sources: the whole source block is staged once in shared memory
//     (16 KiB of float4), then swept in sub-tiles of 32 sources;
//   * the source side, by rotating partials: at step j of a sub-tile lane L
//     takes source L ^ j (32 distinct float4 slots: 4 wavefronts, no extra
//     conflicts), sums that source's share over its kN3R targets in fp32,
//     adds it to the partial it holds and hands the partial on with one
//     __shfl_xor_sync per dimension to the lane that takes the same source
//     at step j + 1. After 32 steps lane L holds the warp's total for
//     source L: DIM/kN3R shuffles per pair, no reduction tree, no atomics;
//   * each warp writes its totals to shared slots only it owns; after the
//     block pair's barrier the CTA sums the kN3Warps slots of a source in
//     fp64 and adds the sum to device memory once.
// Two barriers per block pair: after staging, and before the slots are
// read. Shared memory: 16 KiB of sources + kN3Warps * DIM * 4 KiB of slots
// (48 KiB in 2D, 64 KiB in 3D, dynamic), so 4 (2D) or 3 (3D) CTAs an SM.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#pragma once

#include <cmath>

#include "pair_law.cuh"

namespace nbody {

constexpr int kN3Warps = 4;
constexpr int kN3Threads = 32 * kN3Warps;
constexpr int kN3R = 8;  // targets per lane
constexpr int kN3Block = kN3Threads * kN3R;
static_assert(kChain == 32, "a 32-source sub-tile is one fp32 chain");

template <int DIM>
constexpr int newton3_smem_bytes() {
  return kN3Block * (int)sizeof(float4) +
         kN3Warps * DIM * kN3Block * (int)sizeof(float);
}

// k-th unordered block pair (a, b), b <= a, in row-major triangle order:
// k = a(a+1)/2 + b. ops/cuda_brute.py:_tri_pair is the same map.
__device__ __forceinline__ void tri_pair(long long k, long long* a,
                                         long long* b) {
  long long r = (long long)((sqrt(8.0 * (double)k + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > k) --r;
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  *a = r;
  *b = k - r * (r + 1) / 2;
}

// Body indices are 32-bit unsigned: a row index stays below n + kN3Block
// for n < 2^31 (the C ABI's int), and 64-bit ones would hold registers
// through the sweep.
template <int DIM, bool GUARD, bool SYM>
__device__ __forceinline__ void newton3_block_pair(
    const float4* __restrict__ tgt, const float4* __restrict__ src,
    double* acc_t, double* acc_s, unsigned t, unsigned s, unsigned tb,
    unsigned sb, float soft2, float4* tile, float* slots) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned s0 = sb * kN3Block;
  for (int i = tid; i < kN3Block; i += kN3Threads) {
    tile[i] = s0 + i < s ? src[s0 + i] : pad_body();
  }
  const unsigned t0 = tb * kN3Block + warp * 32 * kN3R + lane;
  float tx[kN3R], ty[kN3R], tz[kN3R], tm[kN3R];
  double ax[kN3R], ay[kN3R], az[kN3R];
#pragma unroll
  for (int r = 0; r < kN3R; ++r) {
    const unsigned idx = t0 + 32 * r;
    const float4 p = idx < t ? tgt[idx] : pad_body();
    tx[r] = p.x;
    ty[r] = p.y;
    tz[r] = p.z;
    tm[r] = p.w;
    ax[r] = ay[r] = az[r] = 0.0;
  }
  __syncthreads();

  float* own = slots + warp * DIM * kN3Block;
  for (int c = 0; c < kN3Block; c += 32) {
    float bx[kN3R], by[kN3R], bz[kN3R];
#pragma unroll
    for (int r = 0; r < kN3R; ++r) bx[r] = by[r] = bz[r] = 0.0f;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    const int cl = c + lane;
    // Unrolled by 2: on the card the fastest depth but for K3 in 3D, where
    // 4 and 8 gain under 0.5%; a full unroll loses 30-40%. It keeps every
    // instance under its former register count without a spill (PERF.md
    // section 6).
#pragma unroll 2
    for (int j = 0; j < 32; ++j) {
      // Before step j, lane L holds the partial of source L ^ j.
      const float4 q = tile[cl ^ j];
      float sx, sy, sz;
#pragma unroll
      for (int r = 0; r < kN3R; ++r) {
        const float dx = q.x - tx[r];
        const float dy = q.y - ty[r];
        const float dz = DIM == 3 ? q.z - tz[r] : 0.0f;
        const float u3 = pair_u3<DIM, GUARD>(dx, dy, dz, soft2);
        const float wt = u3 * q.w;    // m_s * u3: target side
        const float ws = u3 * tm[r];  // m_t * u3: source side
        bx[r] = fmaf(wt, dx, bx[r]);
        by[r] = fmaf(wt, dy, by[r]);
        if (DIM == 3) bz[r] = fmaf(wt, dz, bz[r]);
        sx = r == 0 ? ws * dx : fmaf(ws, dx, sx);
        sy = r == 0 ? ws * dy : fmaf(ws, dy, sy);
        if (DIM == 3) sz = r == 0 ? ws * dz : fmaf(ws, dz, sz);
      }
      // Lane L ^ m takes source L ^ j at step j + 1 (m = j ^ (j + 1));
      // after step 31, m = 31 brings source L's total to lane L.
      const int m = (j ^ (j + 1)) & 31;
      px = __shfl_xor_sync(0xffffffffu, px + sx, m);
      py = __shfl_xor_sync(0xffffffffu, py + sy, m);
      if (DIM == 3) pz = __shfl_xor_sync(0xffffffffu, pz + sz, m);
    }
    own[cl] = px;
    own[kN3Block + cl] = py;
    if (DIM == 3) own[2 * kN3Block + cl] = pz;
#pragma unroll
    for (int r = 0; r < kN3R; ++r) {
      ax[r] += bx[r];
      ay[r] += by[r];
      if (DIM == 3) az[r] += bz[r];
    }
  }
  __syncthreads();
  // The next block pair restages the tile before its first barrier, so
  // nothing below reads the tile; the slots are rewritten only after it.

#pragma unroll
  for (int r = 0; r < kN3R; ++r) {
    const unsigned idx = t0 + 32 * r;
    if (idx < t) {
      const double c = SYM ? (double)tm[r] : 1.0;
      double* out = acc_t + 4 * (size_t)idx;
      atomicAdd(out + 0, c * ax[r]);
      atomicAdd(out + 1, c * ay[r]);
      if (DIM == 3) atomicAdd(out + 2, c * az[r]);
    }
  }
  for (int i = tid; i < kN3Block && s0 + i < s; i += kN3Threads) {
    const unsigned idx = s0 + i;
    const double c = SYM ? -(double)src[idx].w : -1.0;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < kN3Warps; ++w) {
        sum += (double)slots[(w * DIM + d) * kN3Block + i];
      }
      atomicAdd(acc_s + 4 * (size_t)idx + d, c * sum);
    }
  }
}

// K1 (SYM): block pair k of the strict lower triangle, (a + 1, b) for the
// k-th pair (a, b) of tri_pair. K3: target block k / ns, source block k % ns,
// so consecutive CTAs share a target block.
template <int DIM, bool GUARD, bool SYM>
__global__ void __launch_bounds__(kN3Threads, DIM == 2 ? 4 : 3)
newton3_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src,
               double* acc_t, double* acc_s, int t, int s, int ns,
               long long pairs, float soft2) {
  extern __shared__ float4 smem[];
  float* slots = reinterpret_cast<float*>(smem + kN3Block);
  for (long long k = blockIdx.x; k < pairs; k += gridDim.x) {
    long long tb, sb;
    if (SYM) {
      tri_pair(k, &tb, &sb);
      ++tb;
    } else {
      tb = k / ns;
      sb = k % ns;
    }
    newton3_block_pair<DIM, GUARD, SYM>(tgt, src, acc_t, acc_s, t, s,
                                        (unsigned)tb, (unsigned)sb, soft2,
                                        smem, slots);
  }
}

template <int DIM, bool GUARD, bool SYM>
cudaError_t launch_newton3(const float4* tgt, const float4* src,
                           double* acc_t, double* acc_s, int t, int s, int ns,
                           long long pairs, float soft2, cudaStream_t stream) {
  if (pairs <= 0) return cudaSuccess;
  constexpr int smem = newton3_smem_bytes<DIM>();
  const cudaError_t err = cudaFuncSetAttribute(
      newton3_kernel<DIM, GUARD, SYM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      (unsigned)(pairs < 0x7fffffffLL ? pairs : 0x7fffffffLL);
  newton3_kernel<DIM, GUARD, SYM><<<grid, kN3Threads, smem, stream>>>(
      tgt, src, acc_t, acc_s, t, s, ns, pairs, soft2);
  return cudaGetLastError();
}

}  // namespace nbody
