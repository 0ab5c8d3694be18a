// K2: one-sided all-pairs accelerations, the "precise" brute-force kernel.
//
// Replaces ops/pallas_brute.py:_kernel_precise (built by _tile_call in mode
// "precise"). It computes, for every target t,
//     out[t] = sum_s m_s * u3(t, s) * (x_s - x_t)      (not scaled by G*m_t)
// and the wrapper (ops/cuda_brute.py) multiplies by G*m_t, as _forces_impl
// does on the TPU.
//
// Design. One thread per target, kThreads per CTA, the GPU Gems 3 ch. 31
// shape of the reference's own kernel (main_cuda.cu:24-57): source tiles of
// kThreads bodies are staged through shared memory as float4 (x, y, z, m)
// and every thread of the CTA reads them as broadcasts. The pair terms are
// summed in fp32 registers in chains of kChain sources; each chain's total
// goes into an fp64 register total (one fp64 add per chain and dimension).
// Without that, a body with one very close neighbour, whose force is
// hundreds of times the RMS force, lost enough in a 2^17-term fp32 sum to
// miss the 1e-4 scale-normalized tolerance at N = 1e5 in 2D.
//
// What bounds it on Hopper: issue rate, not bytes. Per pair a thread issues
// about 9 (2D) to 12 (3D) FP32 add/mul/FMA instructions and one MUFU rsqrt,
// against 16 bytes of shared-memory broadcast per pair and 16 bytes of
// device memory per source per CTA. The FP32 pipe (128 lanes/clk/SM) and
// the MUFU pipe (16 lanes/clk/SM) are the two ceilings; this first version
// does nothing beyond letting them overlap. Register blocking of several
// targets per thread is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// (no --use_fast_math; the pair law's rsqrt is MUFU.RSQ, pair_law.cuh).
#include "pair_law.cuh"

namespace nbody {

constexpr int kPreciseThreads = 256;

template <int DIM, bool GUARD>
__global__ void __launch_bounds__(kPreciseThreads)
precise_accel_kernel(const float4* __restrict__ tgt,
                     const float4* __restrict__ src,
                     float4* __restrict__ out, int t, int s, float soft2) {
  __shared__ float4 tile[kPreciseThreads];
  const long long i = (long long)blockIdx.x * kPreciseThreads + threadIdx.x;
  const float4 p = i < t ? tgt[i] : pad_body();
  double ax = 0.0, ay = 0.0, az = 0.0;

  for (long long s0 = 0; s0 < s; s0 += kPreciseThreads) {
    const long long j = s0 + threadIdx.x;
    tile[threadIdx.x] = j < s ? src[j] : pad_body();
    __syncthreads();
    for (int k0 = 0; k0 < kPreciseThreads; k0 += kChain) {
      float bx = 0.0f, by = 0.0f, bz = 0.0f;
#pragma unroll
      for (int k = k0; k < k0 + kChain; ++k) {
        const float4 q = tile[k];
        const float dx = q.x - p.x;
        const float dy = q.y - p.y;
        const float dz = DIM == 3 ? q.z - p.z : 0.0f;
        const float w = pair_u3<DIM, GUARD>(dx, dy, dz, soft2) * q.w;
        bx = fmaf(w, dx, bx);
        by = fmaf(w, dy, by);
        if (DIM == 3) bz = fmaf(w, dz, bz);
      }
      ax += bx;
      ay += by;
      if (DIM == 3) az += bz;
    }
    __syncthreads();
  }
  if (i < t) out[i] = make_float4((float)ax, (float)ay, (float)az, 0.0f);
}

template <int DIM, bool GUARD>
void launch_precise(const float4* tgt, const float4* src, float4* out, int t,
                    int s, float soft2, cudaStream_t stream) {
  const unsigned grid = (unsigned)((t + kPreciseThreads - 1) / kPreciseThreads);
  precise_accel_kernel<DIM, GUARD>
      <<<grid, kPreciseThreads, 0, stream>>>(tgt, src, out, t, s, soft2);
}

}  // namespace nbody

// tgt: [t, 4] f32 (x, y, z|0, 0); src: [s, 4] f32 (x, y, z|0, m);
// out: [t, 4] f32, fully written. Returns cudaGetLastError() after the launch.
extern "C" int nbody_precise_accel(const void* tgt, const void* src, void* out,
                                   int t, int s, int dim, float soft2,
                                   int guard, void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || t <= 0 || s < 0) return cudaErrorInvalidValue;
  auto* tg = static_cast<const float4*>(tgt);
  auto* sr = static_cast<const float4*>(src);
  auto* o = static_cast<float4*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    guard ? launch_precise<2, true>(tg, sr, o, t, s, soft2, st)
          : launch_precise<2, false>(tg, sr, o, t, s, soft2, st);
  } else {
    guard ? launch_precise<3, true>(tg, sr, o, t, s, soft2, st)
          : launch_precise<3, false>(tg, sr, o, t, s, soft2, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
