// K4: the tile-BVH work-list winner kernel of the port, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingthenextweekcuda_tpu/ops/pallas/
// bvh_winner_kernel.py::_winner_kernel (its per-block body _winner_sub),
// launched there by _run_winner for intersect_packed_bvh. The unit of work
// stays the TPU kernel's: one 128-ray block of the work list, here one CTA
// of 128 threads, one ray each.
//
//  - A block with no live ray or an empty list writes (BIG, -1).
//  - The block's static horizon is reduced once: the largest, over live
//    rays, of min(tcap, max(root exit * (1 + 1e-5) + 1e-4, 0)).
//  - The block walks its front-to-back leaf list in lockstep while the
//    next entry distance is below the horizon. For each leaf every thread
//    re-checks the leaf's slab against its own best t; when no thread of
//    the block needs the leaf (__syncthreads_or) it is skipped. Otherwise
//    the CTA copies the leaf's 12 Havel geometry rows (12 x tile floats,
//    36 KB at the 768 leaf width) into shared memory and each thread
//    scans them in lane order, keeping the first strict minimum below its
//    best t (seeded with tcap, the closest analytic hit).
//  - Output: t and code = 3 << 24 | padded triangle column, or (BIG, -1).
//
// This is the TPU kernel's walk order and winner, tie for tie, so the
// kernel equals the plain torch version (ops/cuda/bvh_winner_kernel.py
// winner_reference) bit for bit. Left out as TPU workarounds: the
// streaming DMA of the Havel rows (they stay in global memory and the
// leaf in use is staged in shared memory), WINNER_SUB block batching,
// the 1024-ray padding and the stats counters.
//
// What bounds it on this card: FP32 work, about 30 operations per ray and
// triangle of every evaluated leaf (768 triangles), read as broadcasts
// from shared memory; the leaf copy moves 36 KB per evaluated leaf and
// block through L2 (the whole mesh pack is a few MB).
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
constexpr int kGeomRows = 12;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < kInvEps ? (d >= 0.0f ? kInvEps : -kInvEps) : d;
  return 1.0f / s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kBlock / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

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
                  const float* __restrict__ trih, int trih_cols, int tile,
                  float tmin, float exit_rel, float exit_abs,
                  float* __restrict__ t_out, int32_t* __restrict__ code_out) {
  extern __shared__ float rows[];  // kGeomRows x tile
  __shared__ float red[kBlock / 32];
  const int b = blockIdx.x;
  const int i = b * kBlock + threadIdx.x;
  const bool live = alive[i] != 0;
  const int count = counts[b];
  if (!__syncthreads_or(live) || count == 0) {
    t_out[i] = kBig;
    code_out[i] = -1;
    return;
  }
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1],
              dz = direction[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float tc = tcap[i];

  // Per-ray ceiling: tcap, capped by the padded root-box exit.
  float tfr = fmaxf((root[0] - ox) * ix, (root[3] - ox) * ix);
  tfr = fminf(tfr, fmaxf((root[1] - oy) * iy, (root[4] - oy) * iy));
  tfr = fminf(tfr, fmaxf((root[2] - oz) * iz, (root[5] - oz) * iz));
  const float exit_pad = tfr * exit_rel + exit_abs;
  const float ceil0 = fminf(tc, fmaxf(exit_pad, 0.0f));
  const float neg_inf = __int_as_float(0xff800000);
  const float tmax = block_max(live ? fminf(tc, ceil0) : neg_inf, red);

  float best = tc;
  int win = -1;
  const int32_t* my_order = order + (size_t)b * n_leaves;
  const float* my_entry = entry + (size_t)b * n_leaves;
  for (int k = 0; k < count; ++k) {
    if (!(my_entry[k] < tmax)) break;  // the same for every thread
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
    const bool node_hit = tf >= tn && tf >= tmin && tn < best && live;
    // Also the barrier that keeps the previous leaf's rows until every
    // thread has scanned them.
    if (!__syncthreads_or(node_hit)) continue;
    const int ts = leaf_tiles[l];
    for (int r = 0; r < kGeomRows; ++r)
      for (int j = threadIdx.x; j < tile; j += kBlock)
        rows[r * tile + j] = trih[(size_t)r * trih_cols + ts + j];
    __syncthreads();
    if (node_hit) {
      float cur = best;
      int lane = -1;
      for (int j = 0; j < tile; ++j) {
        const float nx = rows[j], ny = rows[tile + j], nz = rows[2 * tile + j];
        const float dn = dx * nx + dy * ny + dz * nz;
        const bool ok = dn < -kFltEps;  // back faces culled
        const float inv = 1.0f / (ok ? dn : 1.0f);
        const float t = (rows[3 * tile + j] - (ox * nx + oy * ny + oz * nz)) * inv;
        const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
        const float u = rows[4 * tile + j] * hx + rows[5 * tile + j] * hy +
                        rows[6 * tile + j] * hz + rows[7 * tile + j];
        const float v = rows[8 * tile + j] * hx + rows[9 * tile + j] * hy +
                        rows[10 * tile + j] * hz + rows[11 * tile + j];
        if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
            t < cur) {
          cur = t;
          lane = j;
        }
      }
      if (lane >= 0) {
        best = cur;
        win = ts + lane;
      }
    }
  }
  t_out[i] = win >= 0 ? best : kBig;
  code_out[i] = win >= 0 ? ((3 << 24) | win) : -1;
}

}  // namespace

extern "C" int rtnw_bvh_winner(const float* origin, const float* direction,
                               const unsigned char* alive, const float* tcap,
                               int n_blocks, const int32_t* counts,
                               const int32_t* order, const float* entry,
                               int n_leaves, const float* root,
                               const float* leaf_bounds,
                               const int32_t* leaf_tiles, const float* trih,
                               int tile, float tmin, float* t_out,
                               int32_t* code_out, void* stream) {
  const size_t bytes = (size_t)kGeomRows * tile * sizeof(float);
  if (bytes > (size_t)kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        bvh_winner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // The horizon margin as the plain version rounds it: the Python doubles
  // 1.0 + 1e-5 and 1e-4 rounded to float.
  const float exit_rel = (float)(1.0 + 1e-5);
  const float exit_abs = (float)1e-4;
  bvh_winner_kernel<<<n_blocks, kBlock, bytes, (cudaStream_t)stream>>>(
      origin, direction, alive, tcap, counts, order, entry, n_leaves, root,
      leaf_bounds, leaf_tiles, trih, n_leaves * tile, tile, tmin, exit_rel,
      exit_abs, t_out, code_out);
  return (int)cudaGetLastError();
}
