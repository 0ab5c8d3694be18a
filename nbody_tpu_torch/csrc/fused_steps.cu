// K4: K small-N integration steps of all-pairs gravity in one launch.
//
// Replaces ops/pallas_brute.py:_kernel_fused_steps (fused_smalln_simulate).
// The whole state stays on chip for all K steps; per step there is no launch
// and no device-memory traffic, only the pair sweep. Semantics are those of
// _kernel_fused_steps:885-895:
//   euler:    v += (g*a)*dt;  x += v*dt
//   leapfrog: KDK, vh = v + (g*a(x))*h;  x += vh*dt;  v = vh + (g*a(x))*h,
//             h = 0.5f*dt
// where a is the one-sided sum_s m_s*u3*Delta of pair_law.cuh. The
// integrator updates use __fmul_rn/__fadd_rn so nvcc does not contract them
// into FMAs: they round as the separate torch operations of the plain
// version do. The TPU kernel evaluates a twice a leapfrog step: at the end
// of step k and again at the start of step k + 1, on the same positions.
// Here that force is carried in registers: the same positions, the same code
// and the same order give the same bits, so leapfrog takes one sweep a step
// (plus one before the first) and returns what the two-sweep loop returns.
//
// Design: one thread-block cluster of C CTAs on C SMs (C = kFusedCluster
// where the card places such a cluster with the kernel's shared memory, else
// the portable kFusedPortableCluster; fused_cluster_size decides once, and
// nbody_fused_force_cluster can set either size).
// * Ownership: CTA r owns the contiguous slice of T = ceil(n / C) targets
//   from r * T, and their velocities. Every CTA holds the whole state's
//   float4 (x, y, z|0, m) twice in its dynamic shared memory, double
//   buffered (2 x 2048 x 16 B at most), rows up to the next multiple of
//   kChain padded with the zero-mass pad body, which adds exactly 0.
// * Sweep: the CTA's threads are G target lanes (a multiple of 32, each
//   lane R targets strided by G) x S source splits, so a warp lies in one
//   split and every source load is a shared-memory broadcast. Split s sweeps
//   the whole kChain chains [s*nch/S, (s+1)*nch/S) of the local buffer on
//   pair_u3<DIM, GUARD>, in fp32 chains into fp64 totals as K2 does. Splits
//   1..S-1 leave their totals in shared memory; after a CTA barrier split 0
//   adds them to its own in split order (no atomics, so the result does not
//   depend on timing) and holds the acceleration.
// * Exchange: split 0 kicks and drifts its own targets and writes their new
//   float4 into the NEXT buffer of every CTA of the cluster through
//   distributed shared memory, then comes one cluster barrier (arrive.release
//   + wait.acquire) a force evaluation. One barrier is enough with two
//   buffers: evaluation e reads buffer e % 2 and writes buffer (e + 1) % 2,
//   which evaluation e - 1 read; every CTA finished those reads before the
//   barrier that ends e - 1, and only after it does anyone write that buffer
//   again. The split totals in shared memory are written after that barrier
//   too and read before the next.
//
// What bounds it: FP32 and MUFU issue on C SMs, about 11 (2D) / 14 (3D)
// instructions and one rsqrt a pair on 128 FP32 and 16 MUFU lanes an SM,
// plus one cluster barrier and the split sum a sweep. The single-CTA kernel
// before it ran on one SM of 132; the cluster puts C times the issue rate on
// a sweep and keeps the exchange on chip: a CTA barrier and a cluster barrier
// a step, no device-memory round trip and no grid-wide barrier (a
// cooperative launch's costs ~25 us on an H100, see rate_probe.cu).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include <cooperative_groups.h>

#include <utility>

#include "pair_law.cuh"

namespace cg = cooperative_groups;

namespace nbody {

constexpr int kFusedMax = 2048;
constexpr int kFusedCluster = 16;
constexpr int kFusedPortableCluster = 8;
constexpr int kFusedThreads = 1024;  // a CTA's threads at most, over R
constexpr int kFusedMaxGroup = 128;  // target lanes at most: R = ceil(T / 128)
constexpr int kFusedMaxSplits = 16;

// A launch's shape for n bodies on a cluster of c CTAs.
struct FusedPlan {
  int slice;   // T: targets a CTA owns
  int rows;    // R: targets a lane holds
  int group;   // G: target lanes, a multiple of 32
  int splits;  // S: source splits
  int threads() const { return group * splits; }
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

inline FusedPlan fused_plan(int n, int c) {
  FusedPlan p;
  const int nch = round_up(n, kChain) / kChain;
  p.slice = (n + c - 1) / c;
  p.rows = (p.slice + kFusedMaxGroup - 1) / kFusedMaxGroup;
  p.group = round_up((p.slice + p.rows - 1) / p.rows, 32);
  p.splits = kFusedThreads / p.rows / p.group;
  if (p.splits > kFusedMaxSplits) p.splits = kFusedMaxSplits;
  if (p.splits > nch) p.splits = nch;
  return p;
}

// Both buffers, then splits 1..S-1's fp64 totals [S-1][DIM][G*R].
inline size_t fused_smem(int n, int dim, const FusedPlan& p) {
  return 2 * sizeof(float4) * round_up(n, kChain) +
         sizeof(double) * (p.splits - 1) * dim * p.group * p.rows;
}

// The most any launch asks for: both buffers at kFusedMax, and 3D totals
// for every target of every split (S * G * R <= kFusedThreads).
constexpr size_t kFusedSmemMax =
    2 * sizeof(float4) * kFusedMax + sizeof(double) * kFusedThreads * 3;

// Split sums: fp32 chains of kChain sources from src[0, n_src) into fp64
// totals t, for R targets p.
template <int DIM, bool GUARD, int R>
__device__ __forceinline__ void split_sums(const float4* src, int n_src,
                                           const float4 (&p)[R], float soft2,
                                           double (&t)[R][DIM]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) t[r][d] = 0.0;
  }
  for (int k0 = 0; k0 < n_src; k0 += kChain) {
    float b[R][DIM];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) b[r][d] = 0.0f;
    }
#pragma unroll 8
    for (int k = k0; k < k0 + kChain; ++k) {
      const float4 q = src[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = q.x - p[r].x;
        const float dy = q.y - p[r].y;
        const float dz = DIM == 3 ? q.z - p[r].z : 0.0f;
        const float w = pair_u3<DIM, GUARD>(dx, dy, dz, soft2) * q.w;
        b[r][0] = fmaf(w, dx, b[r][0]);
        b[r][1] = fmaf(w, dy, b[r][1]);
        if constexpr (DIM == 3) b[r][2] = fmaf(w, dz, b[r][2]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) t[r][d] += b[r][d];
    }
  }
}

// Up to kFusedThreads / R threads a CTA: the bound caps registers at 64 x R a
// thread so that no launch is refused.
template <int DIM, bool GUARD, int R, bool LEAPFROG>
__global__ void __launch_bounds__(kFusedThreads / R)
fused_steps_kernel(float4* __restrict__ pm, float4* __restrict__ vel, int n,
                   int steps, float dt, float g, float soft2, int slice,
                   int group, int splits) {
  extern __shared__ float4 fused_smem_f4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_src = (n + kChain - 1) / kChain * kChain;
  float4* const buf = fused_smem_f4;  // [2][n_src]
  double* const part = reinterpret_cast<double*>(buf + 2 * n_src);
  const int stride = group * R;  // a split's totals of one dimension
  const int split = (int)threadIdx.x / group;
  const int lane = (int)threadIdx.x % group;
  const int first = (int)cluster.block_rank() * slice;
  const int ranks = (int)cluster.num_blocks();
  const int nch = n_src / kChain;
  const int c0 = split * nch / splits, c1 = (split + 1) * nch / splits;

  for (int i = threadIdx.x; i < n_src; i += blockDim.x) {
    const float4 q = i < n ? pm[i] : pad_body();
    buf[i] = q;
    if (i >= n) buf[n_src + i] = q;
  }
  int tgt[R];
  bool own[R];
  float4 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = lane + r * group;
    tgt[r] = first + j;
    own[r] = j < slice && tgt[r] < n;
    v[r] = split == 0 && own[r] ? vel[tgt[r]]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float half = __fmul_rn(0.5f, dt);
  float a[R][3] = {};
  float4 p[R];
  int cur = 0;
  // Every CTA of the cluster runs and holds its state before the first
  // store into its shared memory.
  cluster.sync();
#pragma unroll
  for (int r = 0; r < R; ++r) {  // written back as it is when steps == 0
    p[r] = own[r] ? buf[tgt[r]] : pad_body();
  }

  // The force on this lane's targets from buffer cur, into a (split 0).
  auto sweep = [&]() {
    const float4* src = buf + cur * n_src;
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = own[r] ? src[tgt[r]] : pad_body();
    double t[R][DIM];
    split_sums<DIM, GUARD, R>(src + c0 * kChain, (c1 - c0) * kChain, p, soft2,
                              t);
    if (split > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          part[((split - 1) * DIM + d) * stride + lane + r * group] = t[r][d];
        }
      }
    }
    __syncthreads();
    if (split == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          double s = t[r][d];
          for (int q = 1; q < splits; ++q) {
            s += part[((q - 1) * DIM + d) * stride + lane + r * group];
          }
          a[r][d] = __fmul_rn((float)s, g);
        }
      }
    }
  };
  auto kick = [&](float h) {
    if (split != 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r].x = __fadd_rn(v[r].x, __fmul_rn(a[r][0], h));
      v[r].y = __fadd_rn(v[r].y, __fmul_rn(a[r][1], h));
      if (DIM == 3) v[r].z = __fadd_rn(v[r].z, __fmul_rn(a[r][2], h));
    }
  };
  // Split 0 moves its own targets and stores them into the next buffer of
  // every CTA; then the cluster barrier, and the next buffer is current.
  auto drift = [&]() {
    if (split == 0) {
      float4* next = buf + (cur ^ 1) * n_src;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!own[r]) continue;
        float4 q = p[r];
        q.x = __fadd_rn(q.x, __fmul_rn(v[r].x, dt));
        q.y = __fadd_rn(q.y, __fmul_rn(v[r].y, dt));
        if (DIM == 3) q.z = __fadd_rn(q.z, __fmul_rn(v[r].z, dt));
        p[r] = q;
        for (int k = 0; k < ranks; ++k) {
          *cluster.map_shared_rank(next + tgt[r], k) = q;
        }
      }
    }
    cluster.sync();
    cur ^= 1;
  };

  if (LEAPFROG && steps > 0) sweep();
  for (int step = 0; step < steps; ++step) {
    if (!LEAPFROG) sweep();
    kick(LEAPFROG ? half : dt);
    drift();
    if (LEAPFROG) {
      sweep();  // carried into the next step's first kick
      kick(half);
    }
  }
  if (split == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (own[r]) {
        pm[tgt[r]] = p[r];
        vel[tgt[r]] = v[r];
      }
    }
  }
}

// The host side has internal linkage: a static local of a template of
// external linkage is one object across every library loaded in a process,
// so a second instance of this library would find the attributes "set" by
// the first and never set them on its own kernels.
namespace {

// Shared memory past 48 KB and clusters past the portable 8 are opt-in, once
// per kernel.
template <int DIM, bool GUARD, int R, bool LEAPFROG>
cudaError_t allow_cluster() {
  static const cudaError_t err = [] {
    auto* kernel = fused_steps_kernel<DIM, GUARD, R, LEAPFROG>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kFusedSmemMax);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) cudaGetLastError();  // returned, not left behind
    return e;
  }();
  return err;
}

// A launch of c CTAs, one cluster.
inline cudaLaunchConfig_t cluster_config(int c, int threads, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size a launch takes: kFusedCluster where the card places one
// such cluster of the largest launch's shape, else kFusedPortableCluster,
// decided once; or the size nbody_fused_force_cluster set. An
// error of the attribute set or of the query is returned, never mapped to a
// size, and taken off the runtime's last error so that it is not reported
// again by a later launch's check.
int g_forced_cluster = 0;

cudaError_t fused_cluster_size(int* c) {
  static const std::pair<cudaError_t, int> chosen = [] {
    cudaError_t err = allow_cluster<3, false, 1, true>();
    if (err != cudaSuccess) {
      cudaGetLastError();
      return std::make_pair(err, 0);
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        kFusedCluster, kFusedThreads, kFusedSmemMax, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, fused_steps_kernel<3, false, 1, true>, &cfg);
    if (err != cudaSuccess) cudaGetLastError();
    return std::make_pair(err, clusters >= 1 ? kFusedCluster
                                              : kFusedPortableCluster);
  }();
  if (chosen.first != cudaSuccess) return chosen.first;
  *c = g_forced_cluster != 0 ? g_forced_cluster : chosen.second;
  return cudaSuccess;
}

template <int DIM, bool GUARD, int R, bool LEAPFROG>
cudaError_t launch_fused(float4* pm, float4* vel, int n, int steps, float dt,
                         float g, float soft2, int c, const FusedPlan& p,
                         cudaStream_t stream) {
  const cudaError_t err = allow_cluster<DIM, GUARD, R, LEAPFROG>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(c, p.threads(), fused_smem(n, DIM, p), stream, &attr);
  return cudaLaunchKernelEx(&cfg, fused_steps_kernel<DIM, GUARD, R, LEAPFROG>,
                            pm, vel, n, steps, dt, g, soft2, p.slice, p.group,
                            p.splits);
}

template <int DIM, bool GUARD, int R>
cudaError_t launch_fused_integrator(float4* pm, float4* vel, int n,
                                    int steps, float dt, float g, float soft2,
                                    int leapfrog, int c, const FusedPlan& p,
                                    cudaStream_t st) {
  return leapfrog ? launch_fused<DIM, GUARD, R, true>(pm, vel, n, steps, dt,
                                                      g, soft2, c, p, st)
                  : launch_fused<DIM, GUARD, R, false>(pm, vel, n, steps, dt,
                                                       g, soft2, c, p, st);
}

template <int DIM, bool GUARD>
cudaError_t launch_fused_rows(float4* pm, float4* vel, int n, int steps,
                              float dt, float g, float soft2, int leapfrog,
                              cudaStream_t st) {
  int c = 0;
  const cudaError_t err = fused_cluster_size(&c);
  if (err != cudaSuccess) return err;
  const FusedPlan p = fused_plan(n, c);
  return p.rows == 1
             ? launch_fused_integrator<DIM, GUARD, 1>(pm, vel, n, steps, dt,
                                                      g, soft2, leapfrog, c,
                                                      p, st)
             : launch_fused_integrator<DIM, GUARD, 2>(pm, vel, n, steps, dt,
                                                      g, soft2, leapfrog, c,
                                                      p, st);
}

}  // namespace
}  // namespace nbody

// pm: [n, 4] f32 (x, y, z|0, m), vel: [n, 4] f32 (vx, vy, vz|0, 0), both
// updated in place after `steps` steps. n <= 2048. Returns the launch's
// error, else cudaGetLastError().
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
  cudaError_t err;
  if (dim == 2) {
    err = guard ? launch_fused_rows<2, true>(p, v, n, steps, dt, g, soft2,
                                             leapfrog, st)
                : launch_fused_rows<2, false>(p, v, n, steps, dt, g, soft2,
                                              leapfrog, st);
  } else {
    err = guard ? launch_fused_rows<3, true>(p, v, n, steps, dt, g, soft2,
                                             leapfrog, st)
                : launch_fused_rows<3, false>(p, v, n, steps, dt, g, soft2,
                                              leapfrog, st);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Writes the cluster size C later launches take into *c (kFusedCluster or
// kFusedPortableCluster) and returns the query's error.
extern "C" int nbody_fused_cluster_size(int* c) {
  return (int)nbody::fused_cluster_size(c);
}

// Sets the cluster size of later launches: kFusedCluster or
// kFusedPortableCluster, or 0 for the size the card's occupancy decides.
extern "C" int nbody_fused_force_cluster(int c) {
  using namespace nbody;
  if (c != 0 && c != kFusedCluster && c != kFusedPortableCluster) {
    return cudaErrorInvalidValue;
  }
  g_forced_cluster = c;
  return cudaSuccess;
}
