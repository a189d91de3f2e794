// The exact work-list build of the mesh path, for Hopper (sm_90a): the
// per-block front-to-back leaf lists that K4 walks.
//
// Replaces no TPU kernel: the JAX package builds these lists with XLA ops
// (raytracingthenextweekcuda_tpu/ops/pallas/bvh_winner_kernel.py:96,
// build_worklist), and so did the port, with a chunked torch loop that is
// now this kernel's plain version (ops/cuda/bvh_winner_kernel.py
// worklist_reference). It was added because that loop sent every
// (rays x leaves) temporary of its slab test through device memory, once
// per op, with some sixty launches per million rays. On the card it builds
// every list, at any leaf count its shared memory holds (below); past
// 2,048 leaves the JAX package takes a conservative packet-frustum pass
// instead.
//
// One CTA of 128 threads per 128-ray block, K4's unit of work. The block's
// live rays are compacted into shared memory (ballot and popc in a warp, a
// prefix over the warps): origin and tcap, and safe_inv(direction), two
// 16-byte vectors a ray. A group is 32 consecutive leaves in DFS order, so
// neighbours in space; its box (`group_bounds`, built once a device with
// the LeafScene) is the exact min / max of its leaf boxes.
//  - The warps take groups from a shared counter. For group g, lane j
//    tests live rays j, j + 32, j + 64, j + 96 against the group's box and
//    the ballots give the group's 128-bit ray mask.
//  - Unless the mask is empty, lane j owns leaf 32g + j and runs the slab
//    test only for the rays of the mask, in a warp-uniform loop over its
//    set bits, keeping the least entry and whether any ray hit.
//  - The leaves that some ray hits are compacted by ballot and a shared
//    counter into the sort keys (the order-preserving image of the entry
//    above the leaf index; at most kKeyCap in shared memory), and their
//    bits kept a word a group. The keys are sorted by a bitonic network
//    whose comparators all put the smaller key first, over the next power
//    of two >= the count, the slots past the count standing for +inf keys
//    that are never read or written. Each leaf that no ray hits takes its
//    slot after the count in leaf order, from a scan over the groups'
//    words: the plain version's stable sort gives these slots too.
//  - A block that lists more than kKeyCap leaves writes the keys past the
//    cap straight into its rows of `order` and `entry` (the leaf index and
//    the key's upper word), copies the shared ones beside them and runs the
//    same network there, in device memory. Correct at any count, slower.
// Why the lists stay exact: a group box contains each of its leaf boxes,
// and correctly rounded subtraction and multiplication are monotone, so the
// group's slab interval contains the leaf's (entry no later, exit no
// earlier): a ray that passes a leaf's test (tf >= tn, tf >= tmin,
// tn <= tcap) passes its group's, and a ray with a NaN coordinate fails
// both. The plain version counts the leaf hits of rays that miss the
// leaf's group (WORK["group_misses"], ops/cuda/work.py), which stay 0.
//
// What bounds it on this card. The slab tests fall to the group tests and
// the leaves of the groups a ray enters (WORK["group_tests"] and
// ["group_leaf_tests"]), and the bytes of the rows written bound it: each
// block writes its count and L (order, entry) pairs, 1.14 GB a full build
// of 32,768 blocks at 4,336 leaves, about 0.34 ms at 3.35 TB/s. The design
// spends the lanes on the kept tests (a lane a leaf, the rays broadcast
// from shared memory, no (ray, leaf) traffic through memory), sorts only
// the listed leaves, and writes each row once with coalesced stores. Its
// shared memory is 4 KB of rays, at most 8 KB of keys and 8 bytes a group
// (a hit word and a prefix; 1.1 KB at 4,336 leaves), so it grows with L
// only by the groups: up to about 880,000 leaves fit the 227 KB a CTA may
// have, and a launch past that returns the attribute's error. With one
// group (up to 32 leaves) the group box is the root box, which every ray
// given to K4 enters, so the cull saves nothing there; it costs 0.05-0.07
// ms a build on the mesh stand-ins of 2 and 32 leaves, which no benchmark
// cell runs (NVIDIA H100 80GB HBM3, 700 W).
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
constexpr int kGroup = 32;  // leaves a group, a lane each
// The sort keys kept in shared memory (8 KB). The longest list of the
// 48-materialball cell's primary and bounce-2 wavefronts is 96 and 690
// leaves; 2,048 keys hold 9 CTAs a SM against 12, 1% slower.
constexpr int kKeyCap = 1024;

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

// The plain version's hit test of one box (lo, hi) by one compacted ray:
// its entry in *tn when it passes.
__device__ __forceinline__ bool slab_hit(float lo0, float lo1, float lo2, float hi0,
                                         float hi1, float hi2, float4 o, float4 v,
                                         float tmin, float* tn_out) {
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
  *tn_out = tn;
  return tf >= tn && tf >= tmin && tn <= o.w;
}

// Sort keys[0, count) ascending with a bitonic network over the next power
// of two >= count whose comparators all put the smaller key first (the
// first step of each merge compares mirrored slots): a slot past the count
// holds +inf in effect and is never touched, since no comparator moves a
// smaller key into it. `Keys` reads and writes a slot; one __syncthreads a
// step.
template <class Keys>
__device__ void sort_keys(Keys keys, int count) {
  int p2 = 1;
  while (p2 < count) p2 <<= 1;
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < p2 / 2; p += kBlock) {
        const int x = 2 * p - (p & (j - 1));
        const int y = j == (k >> 1) ? (x ^ (k - 1)) : x + j;
        if (y < count) {
          const unsigned long long a = keys.get(x), c = keys.get(y);
          if (a > c) {
            keys.put(x, c);
            keys.put(y, a);
          }
        }
      }
      __syncthreads();
    }
  }
}

struct SharedKeys {
  unsigned long long* key;
  __device__ unsigned long long get(int i) const { return key[i]; }
  __device__ void put(int i, unsigned long long v) const { key[i] = v; }
};

// A row of the outputs as keys: the leaf index in `order`, the key's upper
// word in the bits of `entry`.
struct RowKeys {
  int32_t* order;
  uint32_t* bits;
  __device__ unsigned long long get(int i) const {
    return ((unsigned long long)bits[i] << 32) | (uint32_t)order[i];
  }
  __device__ void put(int i, unsigned long long v) const {
    bits[i] = (uint32_t)(v >> 32);
    order[i] = (int32_t)(v & 0xffffffffu);
  }
};

// Dynamic shared memory: n_keys sort keys, then a hit word and a prefix a
// group.
__global__ void __launch_bounds__(kBlock)
worklist_kernel(const float* __restrict__ origin,
                const float* __restrict__ direction,
                const unsigned char* __restrict__ alive,
                const float* __restrict__ tcap,
                const float* __restrict__ leaf_bounds, int n_leaves,
                const float* __restrict__ group_bounds, int n_keys,
                float tmin, int32_t* __restrict__ counts,
                int32_t* __restrict__ order, float* __restrict__ entry) {
  extern __shared__ unsigned long long s_key[];
  __shared__ float4 s_org[kBlock];  // the live rays' origin xyz and tcap
  __shared__ float4 s_inv[kBlock];  // and safe_inv(direction) xyz
  __shared__ int s_live[kWarps];
  __shared__ int s_hits[kWarps];
  __shared__ int s_next, s_count;
  const int n_groups = (n_leaves + kGroup - 1) / kGroup;
  // Past the keys: a group's hit leaves, a bit each, and the hit leaves of
  // the groups before it.
  unsigned* const s_word = reinterpret_cast<unsigned*>(s_key + n_keys);
  int* const s_pre = reinterpret_cast<int*>(s_word + n_groups);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int i = b * kBlock + tid;
  const int lane = tid & 31, warp = tid >> 5;

  const bool live = alive[i] != 0;
  const unsigned bits = __ballot_sync(kFull, live);
  if (lane == 0) s_live[warp] = __popc(bits);
  if (tid == 0) {
    s_next = 0;
    s_count = 0;
  }
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
  __syncthreads();  // the compacted rays

  const float inf = __int_as_float(0x7f800000);
  const size_t row = (size_t)b * n_leaves;
  uint32_t* const bits_row = reinterpret_cast<uint32_t*>(entry) + row;
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(&s_next, 1);
    g = __shfl_sync(kFull, g, 0);
    if (g >= n_groups) break;
    const float* gb = group_bounds + g;
    const float glo0 = gb[0], glo1 = gb[n_groups], glo2 = gb[2 * n_groups];
    const float ghi0 = gb[3 * n_groups], ghi1 = gb[4 * n_groups],
                ghi2 = gb[5 * n_groups];
    unsigned mask[kBlock / 32];
    bool enters = false;
#pragma unroll
    for (int k = 0; k < kBlock / 32; ++k) {
      const int r = lane + 32 * k;
      bool p = false;
      if (r < n_live) {
        float tn;
        p = slab_hit(glo0, glo1, glo2, ghi0, ghi1, ghi2, s_org[r], s_inv[r], tmin,
                     &tn);
      }
      mask[k] = __ballot_sync(kFull, p);
      enters |= mask[k] != 0u;
    }
    const int l = g * kGroup + lane;
    float m = inf;
    bool any = false;
    if (enters) {  // warp-uniform
      const bool own = l < n_leaves;
      const int lc = own ? l : n_leaves - 1;
      const float lo0 = leaf_bounds[lc], lo1 = leaf_bounds[n_leaves + lc],
                  lo2 = leaf_bounds[2 * n_leaves + lc];
      const float hi0 = leaf_bounds[3 * n_leaves + lc],
                  hi1 = leaf_bounds[4 * n_leaves + lc],
                  hi2 = leaf_bounds[5 * n_leaves + lc];
#pragma unroll
      for (int k = 0; k < kBlock / 32; ++k) {
        unsigned set = mask[k];
        while (set != 0u) {
          const int r = 32 * k + __ffs(set) - 1;
          set &= set - 1u;
          float tn;
          if (slab_hit(lo0, lo1, lo2, hi0, hi1, hi2, s_org[r], s_inv[r], tmin,
                       &tn)) {
            m = fminf(m, tn);
            any = true;
          }
        }
      }
      any = any && own;
    }
    const unsigned word = __ballot_sync(kFull, any);
    if (lane == 0) s_word[g] = word;
    if (word != 0u) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_count, __popc(word));
      base = __shfl_sync(kFull, base, 0);
      if (any) {
        const int slot = base + __popc(word & ((1u << lane) - 1u));
        const unsigned long long key =
            ((unsigned long long)key_bits(m) << 32) | (unsigned)l;
        if (slot < n_keys) {
          s_key[slot] = key;
        } else {  // past the shared keys: straight into the row
          bits_row[slot] = (uint32_t)(key >> 32);
          order[row + slot] = l;
        }
      }
    }
  }
  __syncthreads();  // the keys, the group words and the count

  // The hit leaves before each group: thread t scans groups
  // [t * per, (t + 1) * per), then a prefix over the threads.
  const int per = (n_groups + kBlock - 1) / kBlock;
  int own_hits = 0;
  for (int q = 0; q < per; ++q) {
    const int g = tid * per + q;
    if (g < n_groups) own_hits += __popc(s_word[g]);
  }
  int inclusive = own_hits;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inclusive, o);
    if (lane >= o) inclusive += v;
  }
  if (lane == 31) s_hits[warp] = inclusive;
  __syncthreads();
  int running = inclusive - own_hits;
  for (int w = 0; w < warp; ++w) running += s_hits[w];
  for (int q = 0; q < per; ++q) {
    const int g = tid * per + q;
    if (g < n_groups) {
      s_pre[g] = running;
      running += __popc(s_word[g]);
    }
  }
  const int count = s_count;

  if (count <= n_keys) {
    sort_keys(SharedKeys{s_key}, count);  // its first step syncs s_pre
    for (int k = tid; k < count; k += kBlock) {
      const unsigned long long key = s_key[k];
      order[row + k] = (int32_t)(key & 0xffffffffu);
      entry[row + k] = key_float((uint32_t)(key >> 32));
    }
  } else {
    const RowKeys keys{order + row, bits_row};
    for (int k = tid; k < n_keys; k += kBlock) keys.put(k, s_key[k]);
    __syncthreads();
    sort_keys(keys, count);
    for (int k = tid; k < count; k += kBlock)
      bits_row[k] = __float_as_uint(key_float(bits_row[k]));
  }
  __syncthreads();  // s_pre (a sort of fewer than two keys has no step)

  // Each leaf that no ray hits, after the count in leaf order.
  for (int g = warp; g < n_groups; g += kWarps) {
    const int l = g * kGroup + lane;
    const unsigned word = s_word[g];
    if (l < n_leaves && !((word >> lane) & 1u)) {
      const int k = count + l - (s_pre[g] + __popc(word & ((1u << lane) - 1u)));
      order[row + k] = l;
      entry[row + k] = inf;
    }
  }
  if (tid == 0) counts[b] = count;
}

// A launch's sort keys in shared memory (the next power of two >=
// n_leaves, at most kKeyCap) and its dynamic shared memory in bytes: the
// keys and 8 bytes a group. The kernel's limit is raised to them; past what
// a CTA may have, the call returns the error.
int worklist_smem(int n_leaves, int* n_keys, size_t* bytes) {
  int p = 1;
  while (p < n_leaves && p < kKeyCap) p <<= 1;
  *n_keys = p;
  const size_t n_groups = ((size_t)n_leaves + kGroup - 1) / kGroup;
  *bytes = (size_t)p * sizeof(unsigned long long) + n_groups * 2 * sizeof(int);
  return (int)cudaFuncSetAttribute(worklist_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

}  // namespace

extern "C" int rtnw_worklist(const float* origin, const float* direction,
                             const unsigned char* alive, const float* tcap,
                             int n_blocks, const float* leaf_bounds, int n_leaves,
                             const float* group_bounds, float tmin, int32_t* counts,
                             int32_t* order, float* entry, void* stream) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  int n_keys = 1;
  size_t bytes = 0;
  const int e = worklist_smem(n_leaves, &n_keys, &bytes);
  if (e != 0) return e;
  worklist_kernel<<<n_blocks, kBlock, bytes, (cudaStream_t)stream>>>(
      origin, direction, alive, tcap, leaf_bounds, n_leaves, group_bounds, n_keys,
      tmin, counts, order, entry);
  return (int)cudaGetLastError();
}

// CTAs of the work-list kernel resident on one SM at a launch's shared
// memory over `n_leaves` leaves, and its threads a CTA.
extern "C" int rtnw_worklist_occupancy(int n_leaves, int* ctas, int* threads) {
  int n_keys = 1;
  size_t bytes = 0;
  *threads = kBlock;
  const int e = worklist_smem(n_leaves, &n_keys, &bytes);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, worklist_kernel,
                                                            kBlock, bytes);
}
