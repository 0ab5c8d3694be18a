// K3: Newton-3 rectangular tile over two DISJOINT body blocks.
//
// Replaces ops/pallas_brute.py:_kernel_sym_tile (built by pallas_sym_tile),
// the engine of the symmetric ring's cross-shard tiles. From one sweep of
// every (target, source) pair it returns, in
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
// run to run; compare by tolerance. The TPU also cut a large rectangle into
// chunks for its scoped VMEM; here one launch takes any t x s, its tile
// count in 64 bits, walked grid-stride by the engine.
//
// Design: the Newton-3 tile engine (newton3_tile.cuh), shared with K1's
// off-diagonal block pairs, walked over the rectangle of kN3Block x kN3Block
// tiles; consecutive CTAs share a target block. Targets and sources are two
// arrays, each masked at its own ragged edge with the zero-mass pad body.
// The engine's design and what bounds it (FP32 issue) are described there.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include "newton3_tile.cuh"

// tgt: [t, 4] f32 (x, y, z|0, m); src: [s, 4] f32 (x, y, z|0, m); acc_t
// [t, 4] and acc_s [s, 4] f64, zeroed by the caller, receive acc_t and
// part_s in columns 0..dim-1. Returns the CUDA error of the launch.
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
  const int ns = (s - 1) / kN3Block + 1;
  const long long tiles = (long long)((t - 1) / kN3Block + 1) * ns;
  if (dim == 2) {
    return guard ? launch_newton3<2, true, false>(tg, sr, at, as, t, s, ns,
                                                  tiles, soft2, st)
                 : launch_newton3<2, false, false>(tg, sr, at, as, t, s, ns,
                                                   tiles, soft2, st);
  }
  return guard ? launch_newton3<3, true, false>(tg, sr, at, as, t, s, ns,
                                                tiles, soft2, st)
               : launch_newton3<3, false, false>(tg, sr, at, as, t, s, ns,
                                                 tiles, soft2, st);
}
