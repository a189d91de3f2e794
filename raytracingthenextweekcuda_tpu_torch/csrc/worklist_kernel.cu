// The exact work-list build of the mesh path, for Hopper (sm_90a): the
// per-block front-to-back leaf lists that K4 walks.
//
// Replaces no TPU kernel: the JAX package builds these lists with XLA ops
// (raytracingthenextweekcuda_tpu/ops/pallas/bvh_winner_kernel.py:96,
// build_worklist), and so did the port, with a chunked torch loop that is
// now this kernel's plain version (ops/cuda/bvh_winner_kernel.py
// worklist_reference). It was added because that loop sent every
// (rays x leaves) temporary of its slab test through device memory, once
// per op, with some sixty launches per million rays.
//
// One CTA of 128 threads per 128-ray block, K4's unit of work:
//  - The block's live rays are compacted into shared memory (ballot and
//    popc in a warp, a prefix over the warps): origin and tcap, and
//    safe_inv(direction), two 16-byte vectors a ray. A block with no live
//    ray tests nothing.
//  - Thread t owns leaves t, t + 128, ...: it keeps a leaf's box in
//    registers and runs the plain version's slab test against every live
//    ray of the block, reading each ray as a broadcast from shared memory,
//    and keeps the least entry distance over the rays that hit and whether
//    any did. The (rays x leaves) tests never leave registers and need no
//    reduction across threads.
//  - The block's list: each leaf's key (the order-preserving image of its
//    entry, +inf where no ray hits, above the leaf index) is sorted in
//    shared memory by a bitonic sort over the next power of two >= L, so
//    that ties fall in leaf order, as the plain version's stable sort
//    leaves them. The kernel writes counts, order and entry once.
//
// What bounds it on this card: float32 operations, about 25 a (ray, leaf)
// slab test (bytes: each ray is read once and each list written once). The
// design spends the lanes on those tests alone: leaves across threads, so
// a test is one thread's registers and two broadcast shared-memory loads,
// only live rays tested, and no per-(ray, leaf) traffic through memory.
// With L not a multiple of 32 the last warp of leaves idles in part.
//
// Equal to the plain version: counts and order bit for bit, entry in value.
// Rounding follows it: no fused multiply-add (built with --fmad=false), a
// true division in safe_inv, and minimum and maximum that return NaN when
// an operand is NaN, as torch.minimum and torch.maximum do, so a ray with a
// NaN coordinate hits nothing. An entry of -0.0 is folded to +0.0 before the
// sort, which compares the two as equal as the plain version's does; the
// entry written then reads +0.0 where the plain version's amin may keep
// -0.0 (equal in value; K4 reads the entries only through `<`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvEps = 1e-20f;
constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ull;  // past the last leaf

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < kInvEps ? (d >= 0.0f ? kInvEps : -kInvEps) : d;
  return 1.0f / s;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The order-preserving unsigned image of a float that is not NaN, with -0.0
// folded to +0.0, and its inverse.
__device__ __forceinline__ uint32_t key_bits(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(kBlock)
worklist_kernel(const float* __restrict__ origin,
                const float* __restrict__ direction,
                const unsigned char* __restrict__ alive,
                const float* __restrict__ tcap,
                const float* __restrict__ leaf_bounds, int n_leaves, int n_pow2,
                float tmin, int32_t* __restrict__ counts,
                int32_t* __restrict__ order, float* __restrict__ entry) {
  extern __shared__ unsigned long long s_key[];  // n_pow2 sort keys
  __shared__ float4 s_org[kBlock];  // the live rays' origin xyz and tcap
  __shared__ float4 s_inv[kBlock];  // and safe_inv(direction) xyz
  __shared__ int s_live[kWarps];
  __shared__ int s_hits[kWarps];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int i = b * kBlock + tid;
  const int lane = tid & 31, warp = tid >> 5;

  const bool live = alive[i] != 0;
  const unsigned bits = __ballot_sync(kFull, live);
  if (lane == 0) s_live[warp] = __popc(bits);
  __syncthreads();
  int before = 0, n_live = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_live[w] : 0;
    n_live += s_live[w];
  }
  if (live) {
    const int slot = before + __popc(bits & ((1u << lane) - 1u));
    s_org[slot] = make_float4(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2],
                              tcap[i]);
    s_inv[slot] = make_float4(safe_inv(direction[3 * i]),
                              safe_inv(direction[3 * i + 1]),
                              safe_inv(direction[3 * i + 2]), 0.0f);
  }
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  int hits = 0;
  for (int l = tid; l < n_pow2; l += kBlock) {
    unsigned long long key = kPadKey;
    if (l < n_leaves) {
      float m = inf;
      bool any = false;
      if (n_live > 0) {
        const float lo0 = leaf_bounds[l], lo1 = leaf_bounds[n_leaves + l],
                    lo2 = leaf_bounds[2 * n_leaves + l];
        const float hi0 = leaf_bounds[3 * n_leaves + l],
                    hi1 = leaf_bounds[4 * n_leaves + l],
                    hi2 = leaf_bounds[5 * n_leaves + l];
#pragma unroll 4
        for (int r = 0; r < n_live; ++r) {
          const float4 o = s_org[r];
          const float4 v = s_inv[r];
          float t0 = (lo0 - o.x) * v.x;
          float t1 = (hi0 - o.x) * v.x;
          float tn = min_nan(t0, t1);
          float tf = max_nan(t0, t1);
          t0 = (lo1 - o.y) * v.y;
          t1 = (hi1 - o.y) * v.y;
          tn = max_nan(tn, min_nan(t0, t1));
          tf = min_nan(tf, max_nan(t0, t1));
          t0 = (lo2 - o.z) * v.z;
          t1 = (hi2 - o.z) * v.z;
          tn = max_nan(tn, min_nan(t0, t1));
          tf = min_nan(tf, max_nan(t0, t1));
          if (tf >= tn && tf >= tmin && tn <= o.w) {
            m = fminf(m, tn);
            any = true;
          }
        }
      }
      hits += any;
      key = ((unsigned long long)key_bits(m) << 32) | (unsigned)l;
    }
    s_key[l] = key;
  }
  hits = __reduce_add_sync(kFull, hits);
  if (lane == 0) s_hits[warp] = hits;
  __syncthreads();  // the keys and the hit counts
  int count = 0;
  for (int w = 0; w < kWarps; ++w) count += s_hits[w];

  // With no hit every key is +inf above its leaf index: already in order.
  if (count > 0) {
    for (int k = 2; k <= n_pow2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = tid; p < n_pow2 / 2; p += kBlock) {
          const int x = 2 * p - (p & (j - 1));
          const int y = x + j;
          const unsigned long long a = s_key[x], c = s_key[y];
          if ((a > c) == ((x & k) == 0)) {
            s_key[x] = c;
            s_key[y] = a;
          }
        }
        __syncthreads();
      }
    }
  }

  const size_t row = (size_t)b * n_leaves;
  for (int k = tid; k < n_leaves; k += kBlock) {
    const unsigned long long key = s_key[k];
    order[row + k] = (int32_t)(key & 0xffffffffu);
    entry[row + k] = key_float((uint32_t)(key >> 32));
  }
  if (tid == 0) counts[b] = count;
}

// The dynamic shared memory of a launch over `n_leaves` leaves: the sort
// keys of the next power of two >= n_leaves. The kernel's limit is raised
// to it (above 48 KB with the static arrays from 4,097 leaves; the card's
// 227 KB hold the keys of at most 16,384).
int worklist_smem(int n_leaves, int* n_pow2, size_t* bytes) {
  int p = 1;
  while (p < n_leaves) p <<= 1;
  *n_pow2 = p;
  *bytes = (size_t)p * sizeof(unsigned long long);
  return (int)cudaFuncSetAttribute(worklist_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

}  // namespace

extern "C" int rtnw_worklist(const float* origin, const float* direction,
                             const unsigned char* alive, const float* tcap,
                             int n_blocks, const float* leaf_bounds, int n_leaves,
                             float tmin, int32_t* counts, int32_t* order,
                             float* entry, void* stream) {
  int n_pow2 = 1;
  size_t bytes = 0;
  const int e = worklist_smem(n_leaves, &n_pow2, &bytes);
  if (e != 0) return e;
  worklist_kernel<<<n_blocks, kBlock, bytes, (cudaStream_t)stream>>>(
      origin, direction, alive, tcap, leaf_bounds, n_leaves, n_pow2, tmin, counts,
      order, entry);
  return (int)cudaGetLastError();
}

// CTAs of the work-list kernel resident on one SM at a launch's shared
// memory, and its threads a CTA.
extern "C" int rtnw_worklist_occupancy(int n_leaves, int* ctas, int* threads) {
  int n_pow2 = 1;
  size_t bytes = 0;
  *threads = kBlock;
  const int e = worklist_smem(n_leaves, &n_pow2, &bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, worklist_kernel,
                                                            kBlock, bytes);
}
