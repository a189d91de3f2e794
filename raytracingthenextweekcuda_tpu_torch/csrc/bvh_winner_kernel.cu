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
// triangle column tested. A block scans a leaf when any of its rays needs
// it, most of its rays may not, and a 768-wide tile is partly padding, so
// the design spends the lanes only on the (ray, column) pairs that can win:
//  - Real columns only. A tile's real triangles are a prefix of it
//    (`leaf_count`); the zero padding behind it has a zero normal, fails
//    the back-face test and is neither staged nor scanned.
//  - Per-ray culling. The rays that need the leaf are compacted into a
//    list of m (ballot and popc in a warp, a prefix over the warps), and
//    S = min(32, the largest power of two <= 128 / m) adjacent threads
//    share each listed ray: thread (r, s) tests columns s, s + S, ... and
//    keeps its first strict minimum below the ray's best. The S partial
//    (t, column) pairs are reduced with __shfl_xor_sync, smaller t first,
//    then the lower column.
//  - Vector staging, double-buffered. A leaf is one contiguous run of
//    16-byte vectors of the array-of-structures copy `aos` (n.xyz dc,
//    e1p d1, e2p d2 per column), copied with cp.async into one of two
//    shared-memory buffers; a scan step is three LDS.128. While a leaf is
//    scanned, the next leaf of the list is copied into the other buffer; a
//    prefetched leaf that the re-check then skips costs only its copy.
// Every (ray, column) t is computed by the sequential scan's expression and
// the lexicographic minimum does not depend on the order of comparisons, so
// the winner is the sequential scan's: the kernel equals the plain torch
// version (ops/cuda/bvh_winner_kernel.py winner_reference) bit for bit.
// Left out as TPU workarounds: the streaming DMA of the Havel rows,
// WINNER_SUB block batching and the 1024-ray padding.
//
// Stats. The `kStats` instantiation also writes a block's leaf counters
// [walked, evaluated], as the reference's stats output does: `walked` the
// list positions before the horizon break, `evaluated` those where at least
// one live ray needs the leaf ([0, 0] for a block with no live ray or an
// empty list). A prefetched leaf is not walked until the walk reaches it.
// The production instantiation, kStats = false, carries no counter.
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
constexpr int kColVecs = 3;  // float4 vectors of one column's 12 geometry rows
constexpr int kNoColumn = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the `cols` columns of the leaf whose tile starts at column `first`
// into `buf`. Thread t copies vectors t, t + kBlock, ...: a slot of either
// buffer is always written by the same thread, so a thread that waits for
// its own copies may reuse the slot.
__device__ __forceinline__ void stage_leaf(float4* buf, const float4* __restrict__ aos,
                                           int first, int cols) {
  const float4* src = aos + (size_t)first * kColVecs;
  for (int v = threadIdx.x; v < cols * kColVecs; v += kBlock)
    cp_async16(buf + v, src + v);
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool kStats>
__global__ void __launch_bounds__(kBlock)
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
                  const float4* __restrict__ aos, int buf_cols, float tmin,
                  float exit_rel, float exit_abs, float* __restrict__ t_out,
                  int32_t* __restrict__ code_out, int32_t* __restrict__ stats) {
  extern __shared__ float4 bufs[];  // 2 x buf_cols x kColVecs
  __shared__ float red[kWarps];
  __shared__ float s_ray[6][kBlock];  // origin and direction of each ray
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

  const int buf_vecs = buf_cols * kColVecs;
  const int32_t* my_order = order + (size_t)b * n_leaves;
  const float* my_entry = entry + (size_t)b * n_leaves;
  const int lane = tid & 31, warp = tid >> 5;
  int pf_k = -1;   // the list position whose leaf was prefetched
  int pf_buf = 0;  // and the buffer it went to
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

    // The leaf: prefetched at the previous list position, or copied now.
    const int first = leaf_tiles[l];
    const int cols = leaf_count[l];
    int cur = pf_buf;
    if (pf_k != k) {
      cp_async_wait_all();  // a prefetch of a leaf the walk skipped
      cur = 0;
      stage_leaf(bufs, aos, first, cols);
    }
    cp_async_wait_all();
    __syncthreads();  // the leaf and the list, for every thread
    // Prefetch the next list position's leaf into the other buffer, whose
    // last scan ended before the barrier above.
    if (k + 1 < count && my_entry[k + 1] < tmax) {
      const int ln = my_order[k + 1];
      pf_k = k + 1;
      pf_buf = cur ^ 1;
      stage_leaf(bufs + pf_buf * buf_vecs, aos, leaf_tiles[ln], leaf_count[ln]);
    }

    // S threads a listed ray: thread (r, s) scans columns s, s + S, ...
    const int log_s = m > 64 ? 0 : m > 32 ? 1 : m > 16 ? 2 : m > 8 ? 3 : m > 4 ? 4 : 5;
    const int S = 1 << log_s;
    const int r = tid >> log_s, s = tid & (S - 1);
    float best_t = kBig;
    int col = kNoColumn;
    if (r < m) {
      const int ray = s_list[r];
      const float rox = s_ray[0][ray], roy = s_ray[1][ray], roz = s_ray[2][ray];
      const float rdx = s_ray[3][ray], rdy = s_ray[4][ray], rdz = s_ray[5][ray];
      best_t = s_best[ray];
      const float4* buf = bufs + cur * buf_vecs;
#pragma unroll 2
      for (int j = s; j < cols; j += S) {
        const float4 g0 = buf[kColVecs * j];      // n.xyz, dc
        const float4 g1 = buf[kColVecs * j + 1];  // e1p, d1
        const float4 g2 = buf[kColVecs * j + 2];  // e2p, d2
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
    }
    // The lexicographic (t, column) minimum over a ray's S adjacent lanes
    // (S is uniform and divides 32, so the groups never straddle warps).
    for (int off = S >> 1; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, best_t, off);
      const int oc = __shfl_xor_sync(kFull, col, off);
      if (ot < best_t || (ot == best_t && oc < col)) {
        best_t = ot;
        col = oc;
      }
    }
    if (r < m && s == 0 && col != kNoColumn) {
      const int ray = s_list[r];
      s_best[ray] = best_t;
      s_win[ray] = first + col;
    }
    __syncthreads();  // best and win before the next re-check
  }
  cp_async_wait_all();  // no copy outlives the block
  const float best = s_best[tid];
  const int win = s_win[tid];
  t_out[i] = win >= 0 ? best : kBig;
  code_out[i] = win >= 0 ? ((3 << 24) | win) : -1;
  if (kStats && tid == 0) {
    stats[2 * b] = walked;
    stats[2 * b + 1] = evaluated;
  }
}

// Dynamic shared memory of a launch: two leaf buffers of `buf_cols`
// columns. With the kernel's static arrays they pass 48 KB at 480 columns,
// so the kernel's dynamic limit is raised to them.
template <bool kStats>
int winner_smem(int buf_cols, size_t* bytes) {
  *bytes = 2 * (size_t)buf_cols * kColVecs * sizeof(float4);
  return (int)cudaFuncSetAttribute(bvh_winner_kernel<kStats>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

template <bool kStats>
int launch_winner(const float* origin, const float* direction,
                  const unsigned char* alive, const float* tcap, int n_blocks,
                  const int32_t* counts, const int32_t* order, const float* entry,
                  int n_leaves, const float* root, const float* leaf_bounds,
                  const int32_t* leaf_tiles, const int32_t* leaf_count,
                  const float* aos, int buf_cols, float tmin, float* t_out,
                  int32_t* code_out, int32_t* stats, cudaStream_t stream) {
  size_t bytes = 0;
  const int e = winner_smem<kStats>(buf_cols, &bytes);
  if (e != 0) return e;
  // The horizon margin as the plain version rounds it: the Python doubles
  // 1.0 + 1e-5 and 1e-4 rounded to float.
  const float exit_rel = (float)(1.0 + 1e-5);
  const float exit_abs = (float)1e-4;
  bvh_winner_kernel<kStats><<<n_blocks, kBlock, bytes, stream>>>(
      origin, direction, alive, tcap, counts, order, entry, n_leaves, root,
      leaf_bounds, leaf_tiles, leaf_count, (const float4*)aos, buf_cols, tmin,
      exit_rel, exit_abs, t_out, code_out, stats);
  return (int)cudaGetLastError();
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
                               int buf_cols, float tmin, float* t_out,
                               int32_t* code_out, int32_t* stats, void* stream) {
  // `stats` (n_blocks, 2) int32, or null for the production instantiation.
  const cudaStream_t s = (cudaStream_t)stream;
  if (stats != nullptr)
    return launch_winner<true>(origin, direction, alive, tcap, n_blocks, counts,
                               order, entry, n_leaves, root, leaf_bounds,
                               leaf_tiles, leaf_count, aos, buf_cols, tmin, t_out,
                               code_out, stats, s);
  return launch_winner<false>(origin, direction, alive, tcap, n_blocks, counts,
                              order, entry, n_leaves, root, leaf_bounds,
                              leaf_tiles, leaf_count, aos, buf_cols, tmin, t_out,
                              code_out, nullptr, s);
}

// CTAs of K4 resident on one SM at a launch's shared memory, and its
// threads a CTA.
extern "C" int rtnw_bvh_winner_occupancy(int buf_cols, int* ctas, int* threads) {
  size_t bytes = 0;
  *threads = kBlock;
  const int e = winner_smem<false>(buf_cols, &bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, bvh_winner_kernel<false>, kBlock, bytes);
}
