// K6: per-leaf near-field accelerations of the grid Barnes-Hut tier.
//
// Replaces ops/pallas_p2p.py:_kernel (built by p2p_leaf_pallas). For every
// leaf row l and target slot c it computes
//     out[l, c, :D] = sum_s m_s * (x_s - x_c) * u3,  u = rsqrt(d2 + soft2),
// with u3 zeroed where the raw d2 < 1e-10, always (pair_u3_raw_guard in
// pair_law.cuh, the pair law of grid_tree._point_mass_accel). Mass 0 marks
// an invalid source. Columns >= D of the output are 0. Not scaled by G.
//
// Layout. The TPU kernel takes sources transposed, [NL, 8, S], because
// Mosaic cannot slice 1-D columns. Here sources are float4 rows
// [NL, S, 4] = (x, y, z|0, m), the packed superrow layout the tree already
// gathers (grid_tree._window_rows_raw), with the mass zeroed for invalid
// and parity-masked cells by the caller. Targets are float4 [NL, C, 4].
//
// Design. A CTA takes one leaf row and 32 of its targets, one target per
// lane; its warps split the row's sources: warp w stages source tiles
// w, w + nwarps, ... of 32 bodies into its own shared-memory slot and every
// lane reads them as broadcasts. Each tile is one fp32 chain of kChain = 32
// terms whose total goes into an fp64 register total, as in K2. At the end
// the warps' fp64 partials are summed in warp order through shared memory
// (deterministic). Splitting the sources across warps is what fills the
// card: at 1e6 bodies 2D, theta = 0.25, one launch has 128 rows of 48
// targets against 3072 sources, so one thread per target would occupy 24
// warps on a 132-SM card.
//
// What bounds it on Hopper: issue rate. Per pair about 17 (2D) to 20 (3D)
// instructions (in 2D: 6 FMUL, 3 FFMA, 3 FADD, 2 FSETP, 1 FSEL, one MUFU
// rsqrt and its range check, ~2 LDS), against 16 bytes of shared-memory
// broadcast; device memory sees each source once per 32 targets. The
// capacity-padded rows waste the slots past a leaf's bodies (masses 0).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include "pair_law.cuh"

namespace nbody {

constexpr int kP2PMaxWarps = 16;
static_assert(kChain == 32, "one source tile of 32 is one fp32 chain");

template <int DIM>
__global__ void __launch_bounds__(kP2PMaxWarps * 32)
p2p_leaf_kernel(const float4* __restrict__ tgt, const float4* __restrict__ src,
                float4* __restrict__ out, int c, int s, float soft2) {
  __shared__ float4 tile[kP2PMaxWarps][32];
  __shared__ double part[kP2PMaxWarps][3][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const int ti = blockIdx.y * 32 + lane;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 p = ti < c ? tgt[row * c + ti] : zero;
  const float4* srow = src + row * (long long)s;
  double ax = 0.0, ay = 0.0, az = 0.0;

  for (int s0 = warp * 32; s0 < s; s0 += nwarps * 32) {
    const int j = s0 + lane;
    tile[warp][lane] = j < s ? srow[j] : zero;  // mass 0: adds exactly 0
    __syncwarp();
    float bx = 0.0f, by = 0.0f, bz = 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float4 q = tile[warp][k];
      const float dx = q.x - p.x;
      const float dy = q.y - p.y;
      const float dz = DIM == 3 ? q.z - p.z : 0.0f;
      const float w = pair_u3_raw_guard<DIM>(dx, dy, dz, soft2) * q.w;
      bx = fmaf(w, dx, bx);
      by = fmaf(w, dy, by);
      if (DIM == 3) bz = fmaf(w, dz, bz);
    }
    ax += bx;
    ay += by;
    if (DIM == 3) az += bz;
    __syncwarp();
  }
  part[warp][0][lane] = ax;
  part[warp][1][lane] = ay;
  part[warp][2][lane] = az;
  __syncthreads();
  if (warp == 0 && ti < c) {
    double sx = 0.0, sy = 0.0, sz = 0.0;
    for (int w = 0; w < nwarps; ++w) {
      sx += part[w][0][lane];
      sy += part[w][1][lane];
      sz += part[w][2][lane];
    }
    out[row * c + ti] =
        make_float4((float)sx, (float)sy, DIM == 3 ? (float)sz : 0.0f, 0.0f);
  }
}

}  // namespace nbody

// tgt: [nl, c, 4] f32 (x, y, z|0, ·); src: [nl, s, 4] f32 (x, y, z|0, m);
// out: [nl, c, 4] f32, fully written. nwarps in [1, 16] warps share a row's
// sources. Returns cudaGetLastError() after the launch.
extern "C" int nbody_p2p_leaf(const void* tgt, const void* src, void* out,
                              int nl, int c, int s, int dim, float soft2,
                              int nwarps, void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || nl <= 0 || c <= 0 || s < 0 || nwarps < 1 ||
      nwarps > kP2PMaxWarps || (c + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  auto* tg = static_cast<const float4*>(tgt);
  auto* sr = static_cast<const float4*>(src);
  auto* o = static_cast<float4*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)nl, (unsigned)((c + 31) / 32));
  if (dim == 2) {
    p2p_leaf_kernel<2><<<grid, nwarps * 32, 0, st>>>(tg, sr, o, c, s, soft2);
  } else {
    p2p_leaf_kernel<3><<<grid, nwarps * 32, 0, st>>>(tg, sr, o, c, s, soft2);
  }
  return (int)cudaGetLastError();
}
