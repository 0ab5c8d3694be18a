// K3: Newton-3 rectangular tile over two DISJOINT body blocks.
//
// Replaces ops/pallas_brute.py:_kernel_sym_tile (built by pallas_sym_tile),
// the engine of the segmented driver's cross pairs and of the symmetric
// ring. From one sweep of every (target, source) pair it returns, in
// acceleration units and not scaled by G,
//     acc_t[t]  =  sum_s m_s * u3(t, s) * Delta,     Delta = x_s - x_t,
//     part_s[s] = -sum_t m_t * u3(t, s) * Delta,
// so each unordered cross pair is swept once.
//
// What differs from the TPU. There the grid runs in order on one core and
// the source-side accumulator is a full-width (4, S) block that stays in
// VMEM for the whole launch (pallas_brute.py:676, :682). Here CTAs run
// concurrently and in no order, so both sides go into global fp64
// accumulators by atomicAdd: acc_t [T, 4] and acc_s [S, 4], zeroed by the
// wrapper, which converts them to fp32. The summation order changes from
// run to run; compare by tolerance.
//
// Design: K1's off-diagonal block-pair sweep (symmetric.cu), over the
// rectangle of kTileBlock x kTileBlock tiles instead of a triangle. Each
// thread owns kTileR targets in registers; sources stream through shared
// memory as float4 broadcasts; the source side of each pair is reduced over
// the warp by shuffles, then across the CTA's 4 warps by shared-memory
// atomics, and added to acc_s once per source per CTA. The target side sums
// in fp32 chains of kChain sources into fp64 register totals. Targets and
// sources are two arrays, each masked at its own ragged edge with the
// zero-mass pad body. The weights differ from K1's m_t*m_s*u3: the target
// side takes m_s*u3 and the source side m_t*u3 (two multiplies per pair, as
// K1's one weight costs).
//
// What bounds it on Hopper: issue rate, as K1: about 11 (2D) to 15 (3D)
// FP32 instructions and one MUFU rsqrt per pair, plus the shuffle reduction.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include "pair_law.cuh"

namespace nbody {

constexpr int kTileThreads = 128;
constexpr int kTileR = 8;
constexpr int kTileBlock = kTileThreads * kTileR;

template <int DIM, bool GUARD>
__device__ void sym_tile_block(const float4* __restrict__ tgt,
                               const float4* __restrict__ src,
                               double* __restrict__ acc_t,
                               double* __restrict__ acc_s, long long t,
                               long long s, long long tb, long long sb,
                               float soft2) {
  __shared__ float4 tile[kTileThreads];
  __shared__ float sacc[DIM][kTileThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  float tx[kTileR], ty[kTileR], tz[kTileR], tm[kTileR];
  double ax[kTileR], ay[kTileR], az[kTileR];
#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
    const long long idx = tb * kTileBlock + r * kTileThreads + tid;
    const float4 p = idx < t ? tgt[idx] : pad_body();
    tx[r] = p.x;
    ty[r] = p.y;
    tz[r] = p.z;
    tm[r] = p.w;
    ax[r] = ay[r] = az[r] = 0.0;
  }

  for (int s0 = 0; s0 < kTileBlock; s0 += kTileThreads) {
    const long long sidx = sb * kTileBlock + s0 + tid;
    tile[tid] = sidx < s ? src[sidx] : pad_body();
#pragma unroll
    for (int d = 0; d < DIM; ++d) sacc[d][tid] = 0.0f;
    __syncthreads();

    for (int k0 = 0; k0 < kTileThreads; k0 += kChain) {
      float bx[kTileR], by[kTileR], bz[kTileR];
#pragma unroll
      for (int r = 0; r < kTileR; ++r) bx[r] = by[r] = bz[r] = 0.0f;
      for (int k = k0; k < k0 + kChain; ++k) {
        const float4 q = tile[k];
        float px = 0.0f, py = 0.0f, pz = 0.0f;
#pragma unroll
        for (int r = 0; r < kTileR; ++r) {
          const float dx = q.x - tx[r];
          const float dy = q.y - ty[r];
          const float dz = DIM == 3 ? q.z - tz[r] : 0.0f;
          const float u3 = pair_u3<DIM, GUARD>(dx, dy, dz, soft2);
          const float wt = u3 * q.w;    // m_s * u3: target side
          const float ws = u3 * tm[r];  // m_t * u3: source side
          bx[r] = fmaf(wt, dx, bx[r]);
          by[r] = fmaf(wt, dy, by[r]);
          if (DIM == 3) bz[r] = fmaf(wt, dz, bz[r]);
          px = fmaf(ws, dx, px);
          py = fmaf(ws, dy, py);
          if (DIM == 3) pz = fmaf(ws, dz, pz);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          px += __shfl_xor_sync(0xffffffffu, px, off);
          py += __shfl_xor_sync(0xffffffffu, py, off);
          if (DIM == 3) pz += __shfl_xor_sync(0xffffffffu, pz, off);
        }
        if (lane == 0) {
          atomicAdd(&sacc[0][k], px);
          atomicAdd(&sacc[1][k], py);
          if (DIM == 3) atomicAdd(&sacc[DIM - 1][k], pz);
        }
      }
#pragma unroll
      for (int r = 0; r < kTileR; ++r) {
        ax[r] += bx[r];
        ay[r] += by[r];
        if (DIM == 3) az[r] += bz[r];
      }
    }
    __syncthreads();
    // Each thread then touches only its own tile/sacc slot until the next
    // barrier, so two barriers per tile suffice.
    if (sidx < s) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        atomicAdd(&acc_s[4 * sidx + d], -(double)sacc[d][tid]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kTileR; ++r) {
    const long long idx = tb * kTileBlock + r * kTileThreads + tid;
    if (idx < t) {
      atomicAdd(&acc_t[4 * idx + 0], ax[r]);
      atomicAdd(&acc_t[4 * idx + 1], ay[r]);
      if (DIM == 3) atomicAdd(&acc_t[4 * idx + 2], az[r]);
    }
  }
}

template <int DIM, bool GUARD>
__global__ void __launch_bounds__(kTileThreads)
sym_tile_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src,
                double* __restrict__ acc_t, double* __restrict__ acc_s,
                long long t, long long s, long long ns, long long tiles,
                float soft2) {
  // Consecutive CTAs share a target block and walk its source blocks.
  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    sym_tile_block<DIM, GUARD>(tgt, src, acc_t, acc_s, t, s, k / ns, k % ns,
                               soft2);
  }
}

template <int DIM, bool GUARD>
void launch_sym_tile(const float4* tgt, const float4* src, double* acc_t,
                     double* acc_s, long long t, long long s, float soft2,
                     cudaStream_t stream) {
  const long long nt = (t + kTileBlock - 1) / kTileBlock;
  const long long ns = (s + kTileBlock - 1) / kTileBlock;
  const long long tiles = nt * ns;
  const unsigned grid = (unsigned)(tiles < 0x7fffffffLL ? tiles : 0x7fffffffLL);
  sym_tile_kernel<DIM, GUARD><<<grid, kTileThreads, 0, stream>>>(
      tgt, src, acc_t, acc_s, t, s, ns, tiles, soft2);
}

}  // namespace nbody

// tgt: [t, 4] f32 (x, y, z|0, m); src: [s, 4] f32 (x, y, z|0, m); acc_t
// [t, 4] and acc_s [s, 4] f64, zeroed by the caller, receive acc_t and
// part_s in columns 0..dim-1. Returns cudaGetLastError().
extern "C" int nbody_sym_tile(const void* tgt, const void* src, void* acc_t,
                              void* acc_s, int t, int s, int dim, float soft2,
                              int guard, void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || t <= 0 || s <= 0) return cudaErrorInvalidValue;
  auto* tg = static_cast<const float4*>(tgt);
  auto* sr = static_cast<const float4*>(src);
  auto* at = static_cast<double*>(acc_t);
  auto* as = static_cast<double*>(acc_s);
  auto st = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    guard ? launch_sym_tile<2, true>(tg, sr, at, as, t, s, soft2, st)
          : launch_sym_tile<2, false>(tg, sr, at, as, t, s, soft2, st);
  } else {
    guard ? launch_sym_tile<3, true>(tg, sr, at, as, t, s, soft2, st)
          : launch_sym_tile<3, false>(tg, sr, at, as, t, s, soft2, st);
  }
  return (int)cudaGetLastError();
}
