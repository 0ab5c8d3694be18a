// K1: Newton-3 all-pairs forces, the "symmetric" brute-force kernel.
//
// Replaces ops/pallas_brute.py:_kernel_symmetric (built by _symmetric_call).
// Bodies are cut into square blocks of kSymBlock rows. Every unordered block
// pair (a, b), b <= a, is swept once with the symmetric weight
//     w = m_t * m_s * u3(t, s),    Delta = x_s - x_t,
// adding  w*Delta  to target t and  -w*Delta  to source s. A diagonal block
// (a == b) sweeps all its ordered pairs and adds the target side only. The
// result acc[n, 4] is force / G; the wrapper multiplies by G.
//
// What differs from the TPU. There the grid runs in order on one core, so a
// full-width source accumulator can live in VMEM for the whole launch. Here
// CTAs run concurrently and in no order, so:
//   * the grid enumerates the n_b(n_b+1)/2 block pairs directly from a
//     flattened triangle index (tri_pair), not by the round robin;
//   * both sides go straight into one global fp64 accumulator by atomicAdd,
//     which the wrapper zeroes before the launch. Per CTA that is one atomic
//     per target and per source and dimension; a per-block-pair partials
//     buffer would take gigabytes at N = 2^20. fp64 makes the order in which
//     the n_b partials of a body arrive irrelevant to its rounding;
//   * the summation order changes from run to run: compare by tolerance.
//
// Design. kSymThreads threads per CTA, each owning kSymR targets of the
// target block in registers (strided so loads coalesce). The source block
// streams through shared memory in tiles of kSymThreads float4 bodies, read
// as broadcasts. For each source, a thread sums its kSymR targets' shares in
// registers; a warp then reduces that over its 32 lanes with shuffles, and
// lane 0 adds the warp's share into a per-tile shared-memory accumulator
// (fp32 shared atomics, 4 warps). After the tile each thread adds one
// source's total into global memory. Owning kSymR targets per thread is what
// keeps the shuffle reduction to about 1/5 of the pair arithmetic. The target
// side sums in fp32 chains of kChain sources, each chain's total added to an
// fp64 register total (see pair_law.cuh); those totals cost registers
// (ptxas: 128 in 2D, 168 in 3D, a few bytes of spill).
//
// What bounds it on Hopper: issue rate, not bytes. Per unordered pair a
// thread issues about 11 (2D) to 15 (3D) FP32 add/mul/FMA instructions and
// one MUFU rsqrt, against roughly 19 for the two ordered pairs the one-sided
// kernel sweeps, plus the shuffle reduction above. Device memory traffic is
// 16 bytes per body per CTA and two atomics per body per CTA.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (no --use_fast_math; rsqrtf is the hardware approximation either way).
#include <cmath>

#include "pair_law.cuh"

namespace nbody {

constexpr int kSymThreads = 128;
constexpr int kSymR = 8;
constexpr int kSymBlock = kSymThreads * kSymR;

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

template <int DIM, bool GUARD, bool DIAG>
__device__ void sym_block_pair(const float4* __restrict__ pm,
                               double* __restrict__ acc, long long n,
                               long long tb, long long sb, float soft2) {
  __shared__ float4 tile[kSymThreads];
  __shared__ float sacc[DIM][kSymThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  float tx[kSymR], ty[kSymR], tz[kSymR], tm[kSymR];
  double ax[kSymR], ay[kSymR], az[kSymR];
#pragma unroll
  for (int r = 0; r < kSymR; ++r) {
    const long long idx = tb * kSymBlock + r * kSymThreads + tid;
    const float4 p = idx < n ? pm[idx] : pad_body();
    tx[r] = p.x;
    ty[r] = p.y;
    tz[r] = p.z;
    tm[r] = p.w;
    ax[r] = ay[r] = az[r] = 0.0;
  }

  for (int s0 = 0; s0 < kSymBlock; s0 += kSymThreads) {
    const long long sidx = sb * kSymBlock + s0 + tid;
    tile[tid] = sidx < n ? pm[sidx] : pad_body();
    if (!DIAG) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) sacc[d][tid] = 0.0f;
    }
    __syncthreads();

    for (int k0 = 0; k0 < kSymThreads; k0 += kChain) {
      float bx[kSymR], by[kSymR], bz[kSymR];
#pragma unroll
      for (int r = 0; r < kSymR; ++r) bx[r] = by[r] = bz[r] = 0.0f;
      for (int k = k0; k < k0 + kChain; ++k) {
        const float4 q = tile[k];
        float px = 0.0f, py = 0.0f, pz = 0.0f;
#pragma unroll
        for (int r = 0; r < kSymR; ++r) {
          const float dx = q.x - tx[r];
          const float dy = q.y - ty[r];
          const float dz = DIM == 3 ? q.z - tz[r] : 0.0f;
          const float w =
              pair_u3<DIM, GUARD>(dx, dy, dz, soft2) * (tm[r] * q.w);
          bx[r] = fmaf(w, dx, bx[r]);
          by[r] = fmaf(w, dy, by[r]);
          if (DIM == 3) bz[r] = fmaf(w, dz, bz[r]);
          if (!DIAG) {
            px = fmaf(w, dx, px);
            py = fmaf(w, dy, py);
            if (DIM == 3) pz = fmaf(w, dz, pz);
          }
        }
        if (!DIAG) {
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
      }
#pragma unroll
      for (int r = 0; r < kSymR; ++r) {
        ax[r] += bx[r];
        ay[r] += by[r];
        if (DIM == 3) az[r] += bz[r];
      }
    }
    __syncthreads();
    // Each thread then touches only its own tile/sacc slot until the next
    // barrier, so two barriers per tile suffice.
    if (!DIAG && sidx < n) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        atomicAdd(&acc[4 * sidx + d], -(double)sacc[d][tid]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kSymR; ++r) {
    const long long idx = tb * kSymBlock + r * kSymThreads + tid;
    if (idx < n) {
      atomicAdd(&acc[4 * idx + 0], ax[r]);
      atomicAdd(&acc[4 * idx + 1], ay[r]);
      if (DIM == 3) atomicAdd(&acc[4 * idx + 2], az[r]);
    }
  }
}

template <int DIM, bool GUARD>
__global__ void __launch_bounds__(kSymThreads)
symmetric_kernel(const float4* __restrict__ pm, double* __restrict__ acc,
                 long long n, long long pairs, float soft2) {
  for (long long k = blockIdx.x; k < pairs; k += gridDim.x) {
    long long a, b;
    tri_pair(k, &a, &b);
    if (a == b) {
      sym_block_pair<DIM, GUARD, true>(pm, acc, n, a, b, soft2);
    } else {
      sym_block_pair<DIM, GUARD, false>(pm, acc, n, a, b, soft2);
    }
  }
}

template <int DIM, bool GUARD>
void launch_symmetric(const float4* pm, double* acc, long long n, float soft2,
                      cudaStream_t stream) {
  const long long nb = (n + kSymBlock - 1) / kSymBlock;
  const long long pairs = nb * (nb + 1) / 2;
  const unsigned grid = (unsigned)(pairs < 0x7fffffffLL ? pairs : 0x7fffffffLL);
  symmetric_kernel<DIM, GUARD>
      <<<grid, kSymThreads, 0, stream>>>(pm, acc, n, pairs, soft2);
}

}  // namespace nbody

// pm: [n, 4] f32 (x, y, z|0, m); acc: [n, 4] f64, zeroed by the caller,
// receives force / G in columns 0..dim-1. Returns cudaGetLastError().
extern "C" int nbody_symmetric_forces(const void* pm, void* acc, int n,
                                      int dim, float soft2, int guard,
                                      void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || n <= 0) return cudaErrorInvalidValue;
  auto* p = static_cast<const float4*>(pm);
  auto* a = static_cast<double*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    guard ? launch_symmetric<2, true>(p, a, n, soft2, st)
          : launch_symmetric<2, false>(p, a, n, soft2, st);
  } else {
    guard ? launch_symmetric<3, true>(p, a, n, soft2, st)
          : launch_symmetric<3, false>(p, a, n, soft2, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int nbody_symmetric_block() { return nbody::kSymBlock; }
