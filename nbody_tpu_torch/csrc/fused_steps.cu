// K4: K small-N integration steps of all-pairs gravity in one launch.
//
// Replaces ops/pallas_brute.py:_kernel_fused_steps (fused_smalln_simulate).
// The whole state stays on chip for all K steps; per step there is no launch
// and no device-memory traffic, only the pair sweep. Semantics are those of
// _kernel_fused_steps:885-895:
//   euler:    v += (g*a)*dt;  x += v*dt
//   leapfrog: KDK with two force evaluations per step, nothing carried:
//             vh = v + (g*a(x))*h;  x += vh*dt;  v = vh + (g*a(x))*h,
//             h = 0.5f*dt
// where a is the one-sided sum_s m_s*u3*Delta of pair_law.cuh. The
// integrator updates use __fmul_rn/__fadd_rn so nvcc does not contract them
// into FMAs: they round as the separate torch operations of the plain
// version do.
//
// Design: one CTA holds the whole state. Positions and masses of n <= 2048
// bodies sit as float4 in shared memory (32 KiB at 2048, rows up to the
// next multiple of kChain padded with the zero-mass pad body, which adds
// exactly 0); each thread owns R (1 or 2) bodies, strided by blockDim, and
// keeps their velocities in registers. Per force evaluation: a barrier,
// every thread sweeps all sources from shared memory by broadcast (fp32
// chains of kChain into fp64 totals, as K2), a barrier, then each thread
// writes its bodies' new positions.
//
// What bounds it: FP32 and MUFU issue on ONE SM of 132 — about 10 FP32
// instructions and one rsqrt per pair on 128 FP32 and 16 MUFU lanes. A
// thread-block-cluster (distributed shared memory) or cooperative-grid
// version spread over many SMs is later perf work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include "pair_law.cuh"

namespace nbody {

constexpr int kFusedMax = 2048;

template <int DIM, bool GUARD, int R>
__device__ __forceinline__ void fused_accel(const float4* spm, int n_src,
                                            const float4 (&p)[R], float soft2,
                                            float g, float (&a)[R][3]) {
  double tx[R], ty[R], tz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) tx[r] = ty[r] = tz[r] = 0.0;
  for (int k0 = 0; k0 < n_src; k0 += kChain) {
    float bx[R], by[R], bz[R];
#pragma unroll
    for (int r = 0; r < R; ++r) bx[r] = by[r] = bz[r] = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k0 + kChain; ++k) {
      const float4 q = spm[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = q.x - p[r].x;
        const float dy = q.y - p[r].y;
        const float dz = DIM == 3 ? q.z - p[r].z : 0.0f;
        const float w = pair_u3<DIM, GUARD>(dx, dy, dz, soft2) * q.w;
        bx[r] = fmaf(w, dx, bx[r]);
        by[r] = fmaf(w, dy, by[r]);
        if (DIM == 3) bz[r] = fmaf(w, dz, bz[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tx[r] += bx[r];
      ty[r] += by[r];
      if (DIM == 3) tz[r] += bz[r];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r][0] = __fmul_rn((float)tx[r], g);
    a[r][1] = __fmul_rn((float)ty[r], g);
    a[r][2] = __fmul_rn((float)tz[r], g);
  }
}

// Up to 1024 threads in the one CTA: the bound caps registers at 64 a thread
// so that launch is never refused.
template <int DIM, bool GUARD, int R, bool LEAPFROG>
__global__ void __launch_bounds__(kFusedMax / 2)
fused_steps_kernel(float4* __restrict__ pm,
                                   float4* __restrict__ vel, int n,
                                   int steps, float dt, float g,
                                   float soft2) {
  __shared__ float4 spm[kFusedMax];
  const int n_src = (n + kChain - 1) / kChain * kChain;
  for (int i = threadIdx.x; i < n_src; i += blockDim.x) {
    spm[i] = i < n ? pm[i] : pad_body();
  }
  float4 v[R];
  bool own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    own[r] = i < n;
    v[r] = own[r] ? vel[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float half = __fmul_rn(0.5f, dt);
  float a[R][3];
  float4 p[R];

  // Barrier, sweep, barrier, then each thread moves only its own bodies.
  auto sweep = [&]() {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = own[r] ? spm[threadIdx.x + r * blockDim.x] : pad_body();
    }
    fused_accel<DIM, GUARD, R>(spm, n_src, p, soft2, g, a);
    __syncthreads();
  };
  auto kick = [&](float h) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r].x = __fadd_rn(v[r].x, __fmul_rn(a[r][0], h));
      v[r].y = __fadd_rn(v[r].y, __fmul_rn(a[r][1], h));
      if (DIM == 3) v[r].z = __fadd_rn(v[r].z, __fmul_rn(a[r][2], h));
    }
  };
  auto drift = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!own[r]) continue;
      float4 q = p[r];
      q.x = __fadd_rn(q.x, __fmul_rn(v[r].x, dt));
      q.y = __fadd_rn(q.y, __fmul_rn(v[r].y, dt));
      if (DIM == 3) q.z = __fadd_rn(q.z, __fmul_rn(v[r].z, dt));
      spm[threadIdx.x + r * blockDim.x] = q;
    }
  };

  for (int step = 0; step < steps; ++step) {
    sweep();
    if (LEAPFROG) {
      kick(half);
      drift();
      sweep();
      kick(half);
    } else {
      kick(dt);
      drift();
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (own[r]) {
      pm[i] = spm[i];
      vel[i] = v[r];
    }
  }
}

template <int DIM, bool GUARD, bool LEAPFROG>
void launch_fused(float4* pm, float4* vel, int n, int steps, float dt,
                  float g, float soft2, cudaStream_t stream) {
  // One body per thread up to 1024, two above; warps rounded up.
  if (n <= 1024) {
    const int threads = (n + 31) / 32 * 32;
    fused_steps_kernel<DIM, GUARD, 1, LEAPFROG>
        <<<1, threads, 0, stream>>>(pm, vel, n, steps, dt, g, soft2);
  } else {
    const int threads = ((n + 1) / 2 + 31) / 32 * 32;
    fused_steps_kernel<DIM, GUARD, 2, LEAPFROG>
        <<<1, threads, 0, stream>>>(pm, vel, n, steps, dt, g, soft2);
  }
}

template <int DIM, bool GUARD>
void launch_fused_integrator(float4* pm, float4* vel, int n, int steps,
                             float dt, float g, float soft2, int leapfrog,
                             cudaStream_t stream) {
  leapfrog ? launch_fused<DIM, GUARD, true>(pm, vel, n, steps, dt, g, soft2,
                                            stream)
           : launch_fused<DIM, GUARD, false>(pm, vel, n, steps, dt, g, soft2,
                                             stream);
}

}  // namespace nbody

// pm: [n, 4] f32 (x, y, z|0, m), vel: [n, 4] f32 (vx, vy, vz|0, 0), both
// updated in place after `steps` steps. n <= 2048. Returns
// cudaGetLastError().
extern "C" int nbody_fused_steps(void* pm, void* vel, int n, int dim,
                                 int steps, float dt, float g, float soft2,
                                 int guard, int leapfrog, void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || n <= 0 || n > kFusedMax || steps < 0) {
    return cudaErrorInvalidValue;
  }
  auto* p = static_cast<float4*>(pm);
  auto* v = static_cast<float4*>(vel);
  auto st = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    guard ? launch_fused_integrator<2, true>(p, v, n, steps, dt, g, soft2,
                                             leapfrog, st)
          : launch_fused_integrator<2, false>(p, v, n, steps, dt, g, soft2,
                                              leapfrog, st);
  } else {
    guard ? launch_fused_integrator<3, true>(p, v, n, steps, dt, g, soft2,
                                             leapfrog, st)
          : launch_fused_integrator<3, false>(p, v, n, steps, dt, g, soft2,
                                              leapfrog, st);
  }
  return (int)cudaGetLastError();
}
