// K1: Newton-3 all-pairs forces, the "symmetric" brute-force kernel.
//
// Replaces ops/pallas_brute.py:_kernel_symmetric (built by _symmetric_call).
// Bodies are cut into square blocks of kN3Block rows. Every unordered block
// pair (a, b), b <= a, is swept once with the symmetric weight
//     w = m_t * m_s * u3(t, s),    Delta = x_s - x_t,
// adding  w*Delta  to target t and  -w*Delta  to source s. A diagonal block
// (a == b) sweeps all its ordered pairs and adds the target side only. The
// result acc[n, 4] is force / G; the wrapper multiplies by G.
//
// What differs from the TPU. There the grid runs in order on one core, so a
// full-width source accumulator can live in VMEM for the whole launch. Here
// CTAs run concurrently and in no order, so the grid enumerates block pairs
// directly from a flattened triangle index (tri_pair), and both sides go
// into one global fp64 accumulator, zeroed by the wrapper; fp64 makes the
// order in which a body's partials arrive irrelevant to its rounding, but
// that order changes from run to run: compare by tolerance.
//
// Two launches on the caller's stream, one K1 call:
//   1. diagonal_kernel: one CTA per diagonal block, target side only; the
//      source block is staged once and read as broadcasts. It STORES each
//      body's total, so it runs first.
//   2. the off-diagonal block pairs, the strict lower triangle, through the
//      Newton-3 tile engine (newton3_tile.cuh, shared with K3), which adds
//      both sides by fp64 atomics. Its design and what bounds it (FP32
//      issue, with MUFU.RSQ at a quarter of that rate) are described there.
// The diagonal is 1/n_b of the pairs; keeping it out of the engine keeps
// its branches out of the engine's register budget.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (no --use_fast_math; the pair law's rsqrt is MUFU.RSQ, pair_law.cuh).
#include "newton3_tile.cuh"

namespace nbody {

template <int DIM, bool GUARD>
__global__ void __launch_bounds__(kN3Threads)
diagonal_kernel(const float4* __restrict__ pm, double* __restrict__ acc,
                long long n, float soft2) {
  __shared__ float4 tile[kN3Block];
  const int tid = threadIdx.x;
  const long long b0 = blockIdx.x * (long long)kN3Block;
  for (int i = tid; i < kN3Block; i += kN3Threads) {
    tile[i] = b0 + i < n ? pm[b0 + i] : pad_body();
  }
  float tx[kN3R], ty[kN3R], tz[kN3R];
  double ax[kN3R], ay[kN3R], az[kN3R];
#pragma unroll
  for (int r = 0; r < kN3R; ++r) {
    const float4 p = tile[r * kN3Threads + tid];
    tx[r] = p.x;
    ty[r] = p.y;
    tz[r] = p.z;
    ax[r] = ay[r] = az[r] = 0.0;
  }
  __syncthreads();
  for (int k0 = 0; k0 < kN3Block; k0 += kChain) {
    float bx[kN3R], by[kN3R], bz[kN3R];
#pragma unroll
    for (int r = 0; r < kN3R; ++r) bx[r] = by[r] = bz[r] = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k0 + kChain; ++k) {
      const float4 q = tile[k];
#pragma unroll
      for (int r = 0; r < kN3R; ++r) {
        const float dx = q.x - tx[r];
        const float dy = q.y - ty[r];
        const float dz = DIM == 3 ? q.z - tz[r] : 0.0f;
        const float w = pair_u3<DIM, GUARD>(dx, dy, dz, soft2) * q.w;
        bx[r] = fmaf(w, dx, bx[r]);
        by[r] = fmaf(w, dy, by[r]);
        if (DIM == 3) bz[r] = fmaf(w, dz, bz[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kN3R; ++r) {
      ax[r] += bx[r];
      ay[r] += by[r];
      if (DIM == 3) az[r] += bz[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kN3R; ++r) {
    const long long idx = b0 + r * kN3Threads + tid;
    if (idx < n) {
      const double m = tile[r * kN3Threads + tid].w;
      acc[4 * idx + 0] = m * ax[r];
      acc[4 * idx + 1] = m * ay[r];
      if (DIM == 3) acc[4 * idx + 2] = m * az[r];
    }
  }
}

template <int DIM, bool GUARD>
cudaError_t launch_symmetric(const float4* pm, double* acc, long long n,
                             float soft2, cudaStream_t stream) {
  const long long nb = (n + kN3Block - 1) / kN3Block;
  diagonal_kernel<DIM, GUARD>
      <<<(unsigned)nb, kN3Threads, 0, stream>>>(pm, acc, n, soft2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_newton3<DIM, GUARD, true>(pm, pm, acc, acc, (int)n, (int)n,
                                          0, nb * (nb - 1) / 2, soft2,
                                          stream);
}

}  // namespace nbody

// pm: [n, 4] f32 (x, y, z|0, m); acc: [n, 4] f64, zeroed by the caller,
// receives force / G in columns 0..dim-1. Returns the CUDA error of the
// launches (0 on success).
extern "C" int nbody_symmetric_forces(const void* pm, void* acc, int n,
                                      int dim, float soft2, int guard,
                                      void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || n <= 0) return cudaErrorInvalidValue;
  auto* p = static_cast<const float4*>(pm);
  auto* a = static_cast<double*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    return guard ? launch_symmetric<2, true>(p, a, n, soft2, st)
                 : launch_symmetric<2, false>(p, a, n, soft2, st);
  }
  return guard ? launch_symmetric<3, true>(p, a, n, soft2, st)
               : launch_symmetric<3, false>(p, a, n, soft2, st);
}

extern "C" int nbody_symmetric_block() { return nbody::kN3Block; }
