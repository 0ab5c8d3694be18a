// K6: the leaf near field of the grid Barnes-Hut tier.
//
// Replaces ops/pallas_p2p.py:_kernel, reached through p2p_leaf_pallas. For
// every target t and every source s of the (2k+1)^D neighbour cells of t's
// leaf (cells outside the grid skipped) it computes
//     sum_s m_s * (x_s - x_t) * u3,  u = rsqrt(d2 + soft2),
// with u3 zeroed where the raw d2 < 1e-10, always (pair_u3_raw_guard in
// pair_law.cuh), which also zeroes the self pair. Mass 0 marks an invalid
// source. Not scaled by G. fp32 chains of at most kChain = 32 terms, folded
// into fp64 totals.
//
// Three entries share one pair loop, warp_near_sums, templated over the
// "source runs" it streams (contiguous index ranges of a float4 array):
//
// * nbody_near_field, the path's kernel: it reads the tree itself, the
//   sorted bodies as float4 (x, y, z|0, m) (GridTree.body_pack), cell_start
//   and cell_count, and writes the [N, D] accelerations in sorted-body
//   order. One warp takes one leaf; the 8 warps of a CTA take 8 leaves in
//   Morton order, i.e. the children of one parent (2^D of them) and its
//   siblings, whose (2k+1)^D rings are cell-granular parts of the parent's
//   (2k+2)^D window, so the window's bodies are fetched once into L1 and
//   read by every child. A warp derives its ring from its leaf's Morton id
//   (the 32-bit spread and compact of ops/keys.py), 32 cells at a time:
//   lane j clips cell j and reads its (start, count); the warp then walks
//   the non-empty cells (ballot) as runs [start, start + count).
// * nbody_near_field_occupied, the FMM's near field on the occupied-cell
//   tree (ops/sparse_grid.OccupiedTree, no counterpart in the JAX package):
//   the tree has no dense cell table, so the wrapper hands a
//   [leaves, (2k+1)^D] table of each leaf's ring as leaf rows (-1 for a cell
//   that holds no body) beside the leaves' body runs. One warp takes one
//   32-body target chunk of a leaf (a binary search of the chunks' prefix
//   sum finds it), so a leaf of any size spreads over as many warps as it
//   has chunks: a collapsing core may put tens of thousands of bodies in
//   one leaf of the keys' last level. The warp reads 32 entries of its
//   leaf's row at a time (lane j entry j) and walks the non-empty ones as
//   runs, as nbody_near_field walks its cells; it writes its chunk's sorted
//   rows once, without atomics. One launch a call, no read-back: the grid
//   is sized for the most chunks the leaves can have (leaves + n / 32), and
//   warps past the real total return.
// * nbody_p2p_leaf, the window entry of the JAX layout (p2p_leaf_pallas):
//   targets [NL, C, 4], sources [NL, S, 4] with invalid ones at mass 0;
//   one run a row. It is held against the Pallas kernel in the tests.
//
// The pair loop. A warp takes up to 32 targets at a time (a leaf with more
// loops over chunks: theta = 0.5 has capacity 304). For m targets, tp = m
// rounded up to a power of two, and the 32 / tp lane splits each take tp of
// every tile's 32 sources: at 1e6 bodies 2D, theta = 0.25, a leaf holds ~15
// bodies, so 30 of 32 lanes work where one target a lane would keep 15.
// Sources stream through a 64-slot ring of float4 in shared memory, one
// per warp: each run's bodies are appended as they come (one coalesced
// load a lane), and every 32 real bodies, compacted across cells, make a
// tile. Only the last tile of a warp's chunk is padded (mass 0). The splits'
// fp64 totals meet by xor shuffles; each target's row is written once, by
// its split 0, without atomics: the result is deterministic.
//
// What bounds it on Hopper: issue rate over the real pairs, ~14.7 (2D) to
// ~17.8 (3D) SASS a pair (6-9 FP32, one MUFU.RSQ, one LDS.128 broadcast),
// with MUFU at 16 lanes a clock beside it. It evaluates no padded slot but
// a chunk's last tile, and the path makes one launch per segment where the
// window layout made one per leaf batch and child parity (512 at 1e6 2D)
// behind host gathers, parity copies and packing.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
#include "pair_law.cuh"

namespace nbody {

constexpr int kNearWarps = 8;   // warps of one CTA: leaves, or target chunks
constexpr int kNearRing = 64;   // float4 slots of a warp's source ring
static_assert(kChain == 32, "one tile of 32 sources is one fp32 chain");

__device__ __forceinline__ unsigned spread2(unsigned x) {
  x &= 0x0000FFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

__device__ __forceinline__ unsigned spread3(unsigned x) {
  x &= 0x000003FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

__device__ __forceinline__ unsigned compact2(unsigned x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

__device__ __forceinline__ unsigned compact3(unsigned x) {
  x &= 0x09249249u;
  x = (x | (x >> 2)) & 0x030C30C3u;
  x = (x | (x >> 4)) & 0x0300F00Fu;
  x = (x | (x >> 8)) & 0x030000FFu;
  return (x | (x >> 16)) & 0x000003FFu;
}

// One tile: the lane's target p against ring slots [lo, lo + tp) of the
// tile, one fp32 chain folded into the fp64 totals.
template <int DIM>
__device__ __forceinline__ void tile_sums(const float4* tile, float4 p,
                                          int lo, int tp, float soft2,
                                          double acc[3]) {
  float bx = 0.0f, by = 0.0f, bz = 0.0f;
#pragma unroll 8
  for (int q = 0; q < tp; ++q) {
    const float4 r = tile[lo + q];
    const float dx = r.x - p.x;
    const float dy = r.y - p.y;
    const float dz = DIM == 3 ? r.z - p.z : 0.0f;
    const float w = pair_u3_raw_guard<DIM>(dx, dy, dz, soft2) * r.w;
    bx = fmaf(w, dx, bx);
    by = fmaf(w, dy, by);
    if (DIM == 3) bz = fmaf(w, dz, bz);
  }
  acc[0] += bx;
  acc[1] += by;
  if (DIM == 3) acc[2] += bz;
}

// The pair loop of both entries. Streams the sources of `runs` (a
// for_each over warp-uniform [start, start + len) ranges of src) through
// the warp's ring in tiles of 32, and sums lane split s's share of each
// tile for target p: tiles' slots [s * tp, s * tp + tp). On return every
// lane holds its target's totals over all splits.
template <int DIM, class Runs>
__device__ __forceinline__ void warp_near_sums(const float4* __restrict__ src,
                                               const Runs& runs, float4 p,
                                               int tp, int s, float soft2,
                                               float4* ring, int lane,
                                               double acc[3]) {
  int head = 0, fill = 0;
  runs.for_each([&](long long start, int len) {
    for (int o = 0; o < len; o += 32) {
      const int n = min(32, len - o);
      if (lane < n)
        ring[(head + fill + lane) & (kNearRing - 1)] = src[start + o + lane];
      fill += n;
      if (fill >= 32) {
        __syncwarp();
        tile_sums<DIM>(ring + head, p, s * tp, tp, soft2, acc);
        __syncwarp();
        head ^= 32;
        fill -= 32;
      }
    }
  });
  if (fill > 0) {  // the last tile, padded with mass-0 bodies (add 0)
    if (lane < 32 - fill)
      ring[(head + fill + lane) & (kNearRing - 1)] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
    tile_sums<DIM>(ring + head, p, s * tp, tp, soft2, acc);
    __syncwarp();
  }
  for (int o = tp; o < 32; o <<= 1) {
    acc[0] += __shfl_xor_sync(0xFFFFFFFFu, acc[0], o);
    acc[1] += __shfl_xor_sync(0xFFFFFFFFu, acc[1], o);
    if (DIM == 3) acc[2] += __shfl_xor_sync(0xFFFFFFFFu, acc[2], o);
  }
}

// Lanes per split for m in [1, 32] targets: m rounded up to a power of 2.
__device__ __forceinline__ int split_width(int m) {
  return m <= 1 ? 1 : 1 << (32 - __clz(m - 1));
}

// The (2k+1)^D ring of one leaf as runs of the sorted bodies, in the order
// of grid_tree._neighbor_offsets (first coordinate slowest).
template <int DIM>
struct RingCells {
  const long long* cell_start;
  const long long* cell_count;
  int cx, cy, cz;  // the leaf's grid coords
  int k, side;     // ring radius, cells per axis (2^leaf_level)
  int lane;

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
    const int w = 2 * k + 1;
    const int ncell = DIM == 3 ? w * w * w : w * w;
    for (int base = 0; base < ncell; base += 32) {
      const int i = base + lane;
      long long st = 0;
      int ct = 0;
      if (i < ncell) {
        const int x = cx + (DIM == 3 ? i / (w * w) : i / w) - k;
        const int y = cy + (DIM == 3 ? (i / w) % w : i % w) - k;
        const int z = DIM == 3 ? cz + i % w - k : 0;
        const bool inside = x >= 0 && x < side && y >= 0 && y < side &&
                            (DIM == 2 || (z >= 0 && z < side));
        if (inside) {
          const unsigned id =
              DIM == 3 ? (spread3(x) << 2) | (spread3(y) << 1) | spread3(z)
                       : (spread2(x) << 1) | spread2(y);
          st = cell_start[id];
          ct = (int)cell_count[id];
        }
      }
      unsigned live = __ballot_sync(0xFFFFFFFFu, ct > 0);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        f(__shfl_sync(0xFFFFFFFFu, st, j), __shfl_sync(0xFFFFFFFFu, ct, j));
      }
    }
  }
};

// The ring of one occupied leaf as runs of the sorted bodies: its row of
// the ring table, entries in the order of grid_tree._neighbor_offsets.
struct TableRuns {
  const long long* row;  // [ncell] leaf rows, -1 for an empty cell
  const long long* leaf_start;
  const long long* leaf_count;
  int ncell;
  int lane;

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
    for (int base = 0; base < ncell; base += 32) {
      const int i = base + lane;
      long long st = 0;
      int ct = 0;
      if (i < ncell) {
        const long long j = row[i];
        if (j >= 0) {
          st = leaf_start[j];
          ct = (int)leaf_count[j];
        }
      }
      unsigned live = __ballot_sync(0xFFFFFFFFu, ct > 0);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        f(__shfl_sync(0xFFFFFFFFu, st, j), __shfl_sync(0xFFFFFFFFu, ct, j));
      }
    }
  }
};

// One run: the sources of one window row.
struct OneRun {
  long long start;
  int len;

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
    if (len > 0) f(start, len);
  }
};

template <int DIM>
__global__ void __launch_bounds__(kNearWarps * 32)
near_field_kernel(const float4* __restrict__ body,
                  const long long* __restrict__ cell_start,
                  const long long* __restrict__ cell_count,
                  float* __restrict__ out, int leaf_level, int k, int leaf0,
                  int nleaves, float soft2) {
  __shared__ float4 ring[kNearWarps][kNearRing];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = blockIdx.x * kNearWarps + warp;
  if (li >= nleaves) return;  // warp-uniform; the CTA has no barrier
  const unsigned leaf = (unsigned)(leaf0 + li);
  const int cs = (int)cell_start[leaf];
  const int nt = (int)cell_count[leaf];
  RingCells<DIM> runs;
  runs.cell_start = cell_start;
  runs.cell_count = cell_count;
  if (DIM == 3) {
    runs.cx = (int)compact3(leaf >> 2);
    runs.cy = (int)compact3(leaf >> 1);
    runs.cz = (int)compact3(leaf);
  } else {
    runs.cx = (int)compact2(leaf >> 1);
    runs.cy = (int)compact2(leaf);
    runs.cz = 0;
  }
  runs.k = k;
  runs.side = 1 << leaf_level;
  runs.lane = lane;
  for (int c0 = 0; c0 < nt; c0 += 32) {
    const int m = min(32, nt - c0);
    const int tp = split_width(m);
    const int t = lane & (tp - 1);
    const float4 p = body[cs + c0 + min(t, m - 1)];
    double acc[3] = {0.0, 0.0, 0.0};
    warp_near_sums<DIM>(body, runs, p, tp, lane / tp, soft2, ring[warp],
                        lane, acc);
    if (lane < m) {  // split 0: lane == t
      float* o = out + (long long)(cs + c0 + lane) * DIM;
      o[0] = (float)acc[0];
      o[1] = (float)acc[1];
      if (DIM == 3) o[2] = (float)acc[2];
    }
  }
}

template <int DIM>
__global__ void __launch_bounds__(kNearWarps * 32)
occupied_near_kernel(const float4* __restrict__ body,
                     const long long* __restrict__ table,
                     const long long* __restrict__ leaf_start,
                     const long long* __restrict__ leaf_count,
                     const long long* __restrict__ chunk_end,
                     float* __restrict__ out, int nleaves, int ncell,
                     float soft2) {
  __shared__ float4 ring[kNearWarps][kNearRing];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kNearWarps + warp;
  if (gw >= chunk_end[nleaves - 1]) return;  // warp-uniform; no barrier
  // The warp's leaf: the first whose chunks end past gw.
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chunk_end[mid] > gw) hi = mid; else lo = mid + 1;
  }
  const long long cs = leaf_start[lo];
  const int nt = (int)leaf_count[lo];
  const int c0 = (int)(gw - (chunk_end[lo] - (nt + 31) / 32)) * 32;
  TableRuns runs;
  runs.row = table + (long long)lo * ncell;
  runs.leaf_start = leaf_start;
  runs.leaf_count = leaf_count;
  runs.ncell = ncell;
  runs.lane = lane;
  const int m = min(32, nt - c0);
  const int tp = split_width(m);
  const int t = lane & (tp - 1);
  const float4 p = body[cs + c0 + min(t, m - 1)];
  double acc[3] = {0.0, 0.0, 0.0};
  warp_near_sums<DIM>(body, runs, p, tp, lane / tp, soft2, ring[warp], lane,
                      acc);
  if (lane < m) {  // split 0: lane == t
    float* o = out + (cs + c0 + lane) * DIM;
    o[0] = (float)acc[0];
    o[1] = (float)acc[1];
    if (DIM == 3) o[2] = (float)acc[2];
  }
}

template <int DIM>
__global__ void __launch_bounds__(kNearWarps * 32)
p2p_window_kernel(const float4* __restrict__ tgt,
                  const float4* __restrict__ src, float4* __restrict__ out,
                  int nl, int c, int s, float soft2) {
  __shared__ float4 ring[kNearWarps][kNearRing];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (c + 31) / 32;
  const long long gw = (long long)blockIdx.x * kNearWarps + warp;
  if (gw >= (long long)nl * chunks) return;
  const long long row = gw / chunks;
  const int c0 = (int)(gw % chunks) * 32;
  const int m = min(32, c - c0);
  const int tp = split_width(m);
  const int t = lane & (tp - 1);
  const float4 p = tgt[row * c + c0 + min(t, m - 1)];
  double acc[3] = {0.0, 0.0, 0.0};
  warp_near_sums<DIM>(src, OneRun{row * s, s}, p, tp, lane / tp, soft2,
                      ring[warp], lane, acc);
  if (lane < m)
    out[row * c + c0 + lane] = make_float4(
        (float)acc[0], (float)acc[1], DIM == 3 ? (float)acc[2] : 0.0f, 0.0f);
}

}  // namespace nbody

// body: [n] float4 (x, y, z|0, m) of the sorted bodies; cell_start and
// cell_count: [2^(dim * leaf_level)] int64; out: [n, dim] f32, rows of the
// leaves [leaf0, leaf0 + nleaves) written, the others left as they were.
// Returns cudaGetLastError() after the launch.
extern "C" int nbody_near_field(const void* body, const void* cell_start,
                                const void* cell_count, void* out, int dim,
                                int leaf_level, int k, int leaf0, int nleaves,
                                float soft2, void* stream) {
  using namespace nbody;
  const int max_level = dim == 2 ? 16 : 10;
  if ((dim != 2 && dim != 3) || leaf_level < 0 || leaf_level > max_level ||
      k < 0 || 2 * k + 1 > 1 << 10 || leaf0 < 0 || nleaves < 0)
    return cudaErrorInvalidValue;
  if (nleaves == 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((nleaves + kNearWarps - 1) / kNearWarps);
  auto* b = static_cast<const float4*>(body);
  auto* st = static_cast<const long long*>(cell_start);
  auto* ct = static_cast<const long long*>(cell_count);
  auto* o = static_cast<float*>(out);
  auto strm = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    near_field_kernel<2><<<grid, kNearWarps * 32, 0, strm>>>(
        b, st, ct, o, leaf_level, k, leaf0, nleaves, soft2);
  } else {
    near_field_kernel<3><<<grid, kNearWarps * 32, 0, strm>>>(
        b, st, ct, o, leaf_level, k, leaf0, nleaves, soft2);
  }
  return (int)cudaGetLastError();
}

// body: [n] float4 of the sorted bodies; table: [nleaves, ncell] int64 leaf
// rows of each leaf's ring, -1 for an empty cell; leaf_start, leaf_count:
// [nleaves] int64 body runs, each leaf non-empty; chunk_end: [nleaves] int64,
// the inclusive prefix sum of the leaves' 32-body target chunks; out:
// [n, dim] f32, every leaf's bodies' rows written. Returns
// cudaGetLastError() after the launch.
extern "C" int nbody_near_field_occupied(const void* body, const void* table,
                                         const void* leaf_start,
                                         const void* leaf_count,
                                         const void* chunk_end, void* out,
                                         int dim, int nleaves, int ncell,
                                         long long n, float soft2,
                                         void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || nleaves < 0 || ncell < 0 || n < 0)
    return cudaErrorInvalidValue;
  if (nleaves == 0) return (int)cudaGetLastError();
  // At most one chunk a leaf more than the bodies' own ceil(n / 32).
  const long long warps = nleaves + (n + 31) / 32;
  const long long grid = (warps + kNearWarps - 1) / kNearWarps;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  auto* b = static_cast<const float4*>(body);
  auto* tb = static_cast<const long long*>(table);
  auto* st = static_cast<const long long*>(leaf_start);
  auto* ct = static_cast<const long long*>(leaf_count);
  auto* ce = static_cast<const long long*>(chunk_end);
  auto* o = static_cast<float*>(out);
  auto strm = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    occupied_near_kernel<2><<<(unsigned)grid, kNearWarps * 32, 0, strm>>>(
        b, tb, st, ct, ce, o, nleaves, ncell, soft2);
  } else {
    occupied_near_kernel<3><<<(unsigned)grid, kNearWarps * 32, 0, strm>>>(
        b, tb, st, ct, ce, o, nleaves, ncell, soft2);
  }
  return (int)cudaGetLastError();
}

// tgt: [nl, c, 4] f32 (x, y, z|0, .); src: [nl, s, 4] f32 (x, y, z|0, m);
// out: [nl, c, 4] f32, fully written (columns >= dim 0). Returns
// cudaGetLastError() after the launch.
extern "C" int nbody_p2p_leaf(const void* tgt, const void* src, void* out,
                              int nl, int c, int s, int dim, float soft2,
                              void* stream) {
  using namespace nbody;
  if ((dim != 2 && dim != 3) || nl <= 0 || c <= 0 || s < 0)
    return cudaErrorInvalidValue;
  const long long warps = (long long)nl * ((c + 31) / 32);
  const long long grid = (warps + kNearWarps - 1) / kNearWarps;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  auto* tg = static_cast<const float4*>(tgt);
  auto* sr = static_cast<const float4*>(src);
  auto* o = static_cast<float4*>(out);
  auto strm = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    p2p_window_kernel<2><<<(unsigned)grid, kNearWarps * 32, 0, strm>>>(
        tg, sr, o, nl, c, s, soft2);
  } else {
    p2p_window_kernel<3><<<(unsigned)grid, kNearWarps * 32, 0, strm>>>(
        tg, sr, o, nl, c, s, soft2);
  }
  return (int)cudaGetLastError();
}
