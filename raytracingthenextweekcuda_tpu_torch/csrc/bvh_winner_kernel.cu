// K4: the tile-BVH work-list winner kernel of the port, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingthenextweekcuda_tpu/ops/pallas/
// bvh_winner_kernel.py::_winner_kernel (its per-block body _winner_sub),
// launched there by _run_winner for intersect_packed_bvh. The unit of work
// stays the TPU kernel's: one 128-ray block of the work list, here one CTA
// of 128 threads, thread r owning ray r of the block.
//
//  - A block with no live ray or an empty list writes (BIG, -1).
//  - The block's static horizon is reduced once: the largest, over live
//    rays, of min(tcap, max(root exit * (1 + 1e-5) + 1e-4, 0)).
//  - The block walks its front-to-back leaf list while the next entry
//    distance is below the horizon. For each leaf every owner re-checks
//    the leaf's slab against its ray's live best t (seeded with tcap, the
//    closest analytic hit). A leaf that no ray needs is skipped.
//  - Output: t and code = 3 << 24 | padded triangle column, or (BIG, -1).
//
// What bounds it on this card: FP32 work, about 41 operations per ray and
// triangle column tested. A ray that enters a leaf box meets few of the
// leaf's up to 767 triangles, so the design tests only the columns that can
// win, one warp a (ray, chunk):
//  - Real columns only. A tile's real triangles are a prefix of it
//    (`leaf_count`); the zero padding behind it has a zero normal, fails
//    the back-face test and is never read.
//  - Per-ray culling. The rays that need the leaf are compacted into a
//    list of m (ballot and popc in a warp, a prefix over the warps).
//  - Per-chunk culling. The leaf's columns are cut into chunks of 32, each
//    with a box (`chunk_bounds`, built once at finalize: the chunk's real
//    triangles, widened for rounding). Warp w takes listed rays w, w + 4,
//    ...; lane c tests the ray's entry into chunk box c (a leaf has at most
//    32 chunks, 1024 columns; the host checks it) against the ray's
//    best t before the leaf, and for each entered chunk, in column order,
//    lane j tests column 32c + j, keeping its first strict minimum below
//    that best. The warp's (t, column) minimum (smaller t, then the lower
//    column) goes to s_best / s_win. The warp owns the ray for the whole
//    leaf: no atomics, no pair list.
//  - No staging. A (ray, chunk) reads its 32 columns' 16-byte vectors of
//    `aos` (n.xyz dc, e1p d1, e2p d2 per column) through the read-only L1
//    path; a block's coherent rays enter the same few chunks, so most
//    reads hit L1, and no shared-memory leaf buffer limits the CTAs a SM.
// A chunk left out holds no candidate: the box holds every point that the
// Havel test accepts of its triangles (with the pad of the build), and the
// entry test is loosened by kSlack in t for the rounding of the slab and of
// the hit point, so a triangle hit at t < best lies in an entered chunk.
// Every (ray, column) t is computed by the sequential scan's expression and
// the lexicographic minimum does not depend on the order of comparisons, so
// the winner is the sequential scan's: the kernel equals the plain torch
// version (ops/cuda/bvh_winner_kernel.py winner_reference), which scans
// every real column of a leaf, bit for bit.
// Left out as TPU workarounds: the streaming DMA of the Havel rows,
// WINNER_SUB block batching and the 1024-ray padding.
//
// Stats. The `kStats` instantiation also writes a block's leaf counters
// [walked, evaluated], as the reference's stats output does: `walked` the
// list positions before the horizon break, `evaluated` those where at least
// one live ray needs the leaf ([0, 0] for a block with no live ray or an
// empty list). The production instantiation, kStats = false, carries no
// counter.
//
// Rounding follows the plain version: no fused multiply-add (built with
// --fmad=false) and true divisions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kFltEps = 1.1920929e-7f;
constexpr float kInvEps = 1e-20f;
constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 32;   // columns of a chunk, one a lane
constexpr int kColVecs = 3;  // float4 vectors of one column's 12 geometry rows
constexpr int kNoColumn = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
// The chunk entry test's slack in t, 1 + 2^-16: the slab's and the hit
// point's rounding, relative to t, which the box's pad does not cover.
constexpr float kSlack = 1.0f + 1.0f / 65536.0f;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < kInvEps ? (d >= 0.0f ? kInvEps : -kInvEps) : d;
  return 1.0f / s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <bool kStats>
__global__ void __launch_bounds__(kBlock, 8)
bvh_winner_kernel(const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const unsigned char* __restrict__ alive,
                  const float* __restrict__ tcap, const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ order,
                  const float* __restrict__ entry, int n_leaves,
                  const float* __restrict__ root,
                  const float* __restrict__ leaf_bounds,
                  const int32_t* __restrict__ leaf_tiles,
                  const int32_t* __restrict__ leaf_count,
                  const float4* __restrict__ aos,
                  const float* __restrict__ chunk_bounds, int n_chunks, float tmin,
                  float exit_rel, float exit_abs, float* __restrict__ t_out,
                  int32_t* __restrict__ code_out, int32_t* __restrict__ stats) {
  __shared__ float red[kWarps];
  __shared__ float s_ray[9][kBlock];  // origin, direction, its inverse
  __shared__ float s_best[kBlock];
  __shared__ int s_win[kBlock];
  __shared__ int s_list[kBlock];       // the rays that need the current leaf
  __shared__ int s_hits[2][kWarps];    // needing rays a warp, by list parity
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int i = b * kBlock + tid;
  const bool live = alive[i] != 0;
  const int count = counts[b];
  if (!__syncthreads_or(live) || count == 0) {
    t_out[i] = kBig;
    code_out[i] = -1;
    if (kStats && tid == 0) {
      stats[2 * b] = 0;
      stats[2 * b + 1] = 0;
    }
    return;
  }
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1],
              dz = direction[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float tc = tcap[i];
  s_ray[0][tid] = ox; s_ray[1][tid] = oy; s_ray[2][tid] = oz;
  s_ray[3][tid] = dx; s_ray[4][tid] = dy; s_ray[5][tid] = dz;
  s_ray[6][tid] = ix; s_ray[7][tid] = iy; s_ray[8][tid] = iz;
  s_best[tid] = tc;
  s_win[tid] = -1;

  // Per-ray ceiling: tcap, capped by the padded root-box exit.
  float tfr = fmaxf((root[0] - ox) * ix, (root[3] - ox) * ix);
  tfr = fminf(tfr, fmaxf((root[1] - oy) * iy, (root[4] - oy) * iy));
  tfr = fminf(tfr, fmaxf((root[2] - oz) * iz, (root[5] - oz) * iz));
  const float exit_pad = tfr * exit_rel + exit_abs;
  const float ceil0 = fminf(tc, fmaxf(exit_pad, 0.0f));
  const float neg_inf = __int_as_float(0xff800000);
  // Also the barrier that publishes the rays' rows.
  const float tmax = block_max(live ? fminf(tc, ceil0) : neg_inf, red);

  const int32_t* my_order = order + (size_t)b * n_leaves;
  const float* my_entry = entry + (size_t)b * n_leaves;
  const int lane = tid & 31, warp = tid >> 5;
  int walked = 0, evaluated = 0;  // the stats counters, uniform in the block
  for (int k = 0; k < count; ++k) {
    if (!(my_entry[k] < tmax)) break;  // the same for every thread
    if (kStats) ++walked;
    const int l = my_order[k];
    float tn = fminf((leaf_bounds[l] - ox) * ix,
                     (leaf_bounds[3 * n_leaves + l] - ox) * ix);
    float tf = fmaxf((leaf_bounds[l] - ox) * ix,
                     (leaf_bounds[3 * n_leaves + l] - ox) * ix);
    float t0 = (leaf_bounds[n_leaves + l] - oy) * iy;
    float t1 = (leaf_bounds[4 * n_leaves + l] - oy) * iy;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (leaf_bounds[2 * n_leaves + l] - oz) * iz;
    t1 = (leaf_bounds[5 * n_leaves + l] - oz) * iz;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    const bool node_hit = tf >= tn && tf >= tmin && tn < s_best[tid] && live;

    // Compact the needing rays: ballot and popc in a warp, then a prefix
    // over the warps' counts (double-buffered by list parity, so a thread
    // that skips ahead never overwrites counts another is still reading).
    const unsigned bits = __ballot_sync(kFull, node_hit);
    int* hits = s_hits[k & 1];
    if (lane == 0) hits[warp] = __popc(bits);
    __syncthreads();
    int m = 0, before = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? hits[w] : 0;
      m += hits[w];
    }
    if (m == 0) continue;  // the same for every thread
    if (kStats) ++evaluated;
    if (node_hit) s_list[before + __popc(bits & ((1u << lane) - 1u))] = tid;
    __syncthreads();  // the list, for every warp

    const int cols = leaf_count[l];
    // Lane c holds the box of the leaf's chunk c (at most kChunk chunks a
    // leaf); a lane past the leaf's chunks holds an empty one.
    const float* box = chunk_bounds + (size_t)l * 6 * n_chunks + lane;
    const bool in_leaf = lane * kChunk < cols;
    const float inf = __int_as_float(0x7f800000);
    const float bx0 = in_leaf ? box[0] : inf, bx1 = in_leaf ? box[3 * n_chunks] : inf;
    const float by0 = in_leaf ? box[n_chunks] : inf;
    const float by1 = in_leaf ? box[4 * n_chunks] : inf;
    const float bz0 = in_leaf ? box[2 * n_chunks] : inf;
    const float bz1 = in_leaf ? box[5 * n_chunks] : inf;
    const float4* tile = aos + (size_t)leaf_tiles[l] * kColVecs;
    // Warp w: listed rays w, w + kWarps, ...; the whole warp a ray.
    for (int r = warp; r < m; r += kWarps) {
      const int ray = s_list[r];
      const float rox = s_ray[0][ray], roy = s_ray[1][ray], roz = s_ray[2][ray];
      const float rdx = s_ray[3][ray], rdy = s_ray[4][ray], rdz = s_ray[5][ray];
      const float rix = s_ray[6][ray], riy = s_ray[7][ray], riz = s_ray[8][ray];
      const float best0 = s_best[ray];  // the ray's best before the leaf
      // Lane c: the ray's entry into chunk box c, the leaf's slab
      // expression with the slack in t.
      float cn = fminf((bx0 - rox) * rix, (bx1 - rox) * rix);
      float cf = fmaxf((bx0 - rox) * rix, (bx1 - rox) * rix);
      float c_lo = (by0 - roy) * riy, c_hi = (by1 - roy) * riy;
      cn = fmaxf(cn, fminf(c_lo, c_hi));
      cf = fminf(cf, fmaxf(c_lo, c_hi));
      c_lo = (bz0 - roz) * riz;
      c_hi = (bz1 - roz) * riz;
      cn = fmaxf(cn, fminf(c_lo, c_hi));
      cf = fminf(cf, fmaxf(c_lo, c_hi));
      const float cfs = cf * kSlack;
      const bool enters = in_leaf && cfs >= cn && cfs >= tmin && cn < best0 * kSlack;
      float best_t = best0;
      int col = kNoColumn;
      // The entered chunks in column order; lane j tests column 32c + j.
      for (unsigned in = __ballot_sync(kFull, enters); in != 0; in &= in - 1) {
        const int j = (__ffs(in) - 1) * kChunk + lane;
        if (j >= cols) continue;
        const float4 g0 = __ldg(tile + kColVecs * j);      // n.xyz, dc
        const float4 g1 = __ldg(tile + kColVecs * j + 1);  // e1p, d1
        const float4 g2 = __ldg(tile + kColVecs * j + 2);  // e2p, d2
        const float dn = rdx * g0.x + rdy * g0.y + rdz * g0.z;
        const bool ok = dn < -kFltEps;  // back faces culled
        const float inv = 1.0f / (ok ? dn : 1.0f);
        const float t = (g0.w - (rox * g0.x + roy * g0.y + roz * g0.z)) * inv;
        const float hx = rox + t * rdx, hy = roy + t * rdy, hz = roz + t * rdz;
        const float u = g1.x * hx + g1.y * hy + g1.z * hz + g1.w;
        const float v = g2.x * hx + g2.y * hy + g2.z * hz + g2.w;
        if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
            t < best_t) {
          best_t = t;
          col = j;
        }
      }
      // The warp's lexicographic (t, column) minimum, where a lane found
      // a candidate.
      if (!__any_sync(kFull, col != kNoColumn)) continue;
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kFull, best_t, off);
        const int oc = __shfl_xor_sync(kFull, col, off);
        if (ot < best_t || (ot == best_t && oc < col)) {
          best_t = ot;
          col = oc;
        }
      }
      if (lane == 0 && col != kNoColumn) {
        s_best[ray] = best_t;
        s_win[ray] = leaf_tiles[l] + col;
      }
    }
    __syncthreads();  // best and win before the next re-check
  }
  const float best = s_best[tid];
  const int win = s_win[tid];
  t_out[i] = win >= 0 ? best : kBig;
  code_out[i] = win >= 0 ? ((3 << 24) | win) : -1;
  if (kStats && tid == 0) {
    stats[2 * b] = walked;
    stats[2 * b + 1] = evaluated;
  }
}

}  // namespace

extern "C" int rtnw_bvh_winner(const float* origin, const float* direction,
                               const unsigned char* alive, const float* tcap,
                               int n_blocks, const int32_t* counts,
                               const int32_t* order, const float* entry,
                               int n_leaves, const float* root,
                               const float* leaf_bounds,
                               const int32_t* leaf_tiles,
                               const int32_t* leaf_count, const float* aos,
                               const float* chunk_bounds, int n_chunks, float tmin,
                               float* t_out, int32_t* code_out, int32_t* stats,
                               void* stream) {
  // `chunk_bounds` (n_leaves, 6, n_chunks); `stats` (n_blocks, 2) int32, or
  // null for the production instantiation.
  const cudaStream_t s = (cudaStream_t)stream;
  // The horizon margin as the plain version rounds it: the Python doubles
  // 1.0 + 1e-5 and 1e-4 rounded to float.
  const float exit_rel = (float)(1.0 + 1e-5);
  const float exit_abs = (float)1e-4;
  if (stats != nullptr)
    bvh_winner_kernel<true><<<n_blocks, kBlock, 0, s>>>(
        origin, direction, alive, tcap, counts, order, entry, n_leaves, root,
        leaf_bounds, leaf_tiles, leaf_count, (const float4*)aos, chunk_bounds,
        n_chunks, tmin, exit_rel, exit_abs, t_out, code_out, stats);
  else
    bvh_winner_kernel<false><<<n_blocks, kBlock, 0, s>>>(
        origin, direction, alive, tcap, counts, order, entry, n_leaves, root,
        leaf_bounds, leaf_tiles, leaf_count, (const float4*)aos, chunk_bounds,
        n_chunks, tmin, exit_rel, exit_abs, t_out, code_out, nullptr);
  return (int)cudaGetLastError();
}

// CTAs of K4 resident on one SM, and its threads a CTA.
extern "C" int rtnw_bvh_winner_occupancy(int* ctas, int* threads) {
  *threads = kBlock;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, bvh_winner_kernel<false>, kBlock, 0);
}
