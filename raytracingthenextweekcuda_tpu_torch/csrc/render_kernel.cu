// The bounce kernels of the port, for Hopper (sm_90a): K1, K2 and K0.
//
// They replace three TPU kernels of raytracingthenextweekcuda_tpu/ops/
// pallas/bounce_kernel.py, which share one bounce body (_bounce_core) as
// these share `bounce`:
// - K1 `render_kernel` replaces _render_kernel (with _raygen_core and
//   _trace_sample), launched there by _run_render for render_samples. One
//   thread renders one pixel: for each sample it generates the thin-lens
//   primary ray from pcg4d and follows it through up to `bounces` bounces,
//   summing the radiance in registers and writing it once. It runs one
//   loop over bounce steps and regenerates: a lane whose path has ended
//   starts its pixel's next sample at the next step (see below).
// - K2 `path_kernel` replaces _path_kernel (_run_path, path_trace): it
//   follows supplied rays through the whole bounce loop on a persistent
//   grid and regenerates as K1 does (see below).
// - K0 `bounce_kernel` replaces _bounce_kernel (_run_bounce, bounce_step):
//   one thread advances one ray of the planar carry by one bounce, on
//   uniforms read from memory (see the comment above the kernel).
// A bounce is the closest hit over spheres, planes, Havel triangles, Havel
// quads and oriented boxes, in that order; the 8-kind BSDF; sky, additive
// emission and emission termination; optional Russian roulette.
//
// On a tile-BVH pack the triangles are found by a walk of the tile-BVH
// instead (after spheres and planes), in the instantiation with kBvh =
// true; the other instantiation compiles the walk away, as the TPU kernel
// does with n_bvh_nodes = 0. It replaces the TPU kernel's block-consensus
// skip-pointer walk (_bounce_core, bounce_kernel.py:820-1044), which
// visits a node when any ray of a 1024-ray block hits its box and tests a
// leaf's tile for the rows whose rays hit it. Here the consensus is a
// warp's: the lanes that trace the bounce (`walkers`, a ballot taken at
// the call site, never a full mask or __activemask) walk one DFS node
// sequence with a warp-uniform node. Each lane slab-tests the node against
// its own ray and its own best t; the warp descends to node + 1 when a
// ballot says any lane hit the box, else it jumps to the skip pointer. A
// child's box lies inside its parent's and the slab arithmetic rounds
// monotonically in the bounds, so a lane that misses a box misses all it
// holds: each lane meets the leaves a walk of its ray alone meets, in the
// same order, with the same best t. What bounds the walk on this card is
// FP32 work, about 41 operations per Havel column of each leaf a ray
// enters and 25 per node box it tests. The design spends the lanes only on
// (ray, column) pairs that can win, as K4 does:
// - Real columns only. A leaf's real triangles are a prefix of its tile
//   (`bvh_c`, per node); the zero padding behind them has a zero normal,
//   fails the back-face test and is not scanned.
// - The leaf's columns are shared by the walking lanes. The m lanes that
//   hit a leaf are compacted by ballot and popc, and S = the largest power
//   of two <= k / m (k walking lanes) workers take each needing ray: the
//   worker of rank r * S + s among the walkers tests columns s, s + S, ...
//   of needing ray r (its origin, direction and best t come by shuffles)
//   and keeps its first strict minimum below that best. The S partial (t,
//   column) pairs are reduced by shuffles, smaller t first, then the lower
//   column, and the needing lane takes the result. The minimum does not
//   depend on the order of comparisons, so the winner is the sequential
//   scan's (strict t < best, the lowest column among equal t).
// - Columns as 16-byte vectors: the scan reads a column's 12 Havel
//   geometry rows as 3 float4 from the array-of-structures copy `aos`.
// The winner's normal and material rows are read from its column of
// `trih` once, after the walk. No __syncthreads runs in any bounce loop,
// and no leaf is staged per CTA: the lanes of a CTA are at different
// bounces and samples.
//
// A thread of K1 or K2 leaves a path as soon as it dies. The TPU kernels
// run a 1024-ray block until every ray in it has died; a dead ray's bounce
// there adds nothing and keeps its state, so the two agree.
// The material kinds are a per-thread switch; for the winning kind it
// gives what the TPU kernel's branchless select chain gives, including the
// default (the Lambertian direction, `scattered = kind != EMISSION`).
//
// What bounds it on this card: FP32 ALU work (a few hundred operations per
// primitive column per bounce) and warp divergence (paths of one warp die
// at different bounces and hit different kinds). Path lengths are very
// uneven (the Cornell box is open to the sky at the front: a path leaves
// after a bounce or two, ends at the light, or runs all its bounces). A
// loop over samples with the bounces inside would run each sample of a
// warp for as many bounces as its longest path; K1 and K2 regenerate
// instead, so a warp's time is about the largest of its lanes' summed path
// lengths. The path start is then the divergent part, which the waiting
// lanes of a warp take together. K1's camera frame sits in shared memory,
// not in 21 registers a thread (it cost 56 bytes of spills there). Memory
// traffic is negligible: the packed scene rows are read from shared memory
// and each pixel writes 12 bytes once. Scene rows at their true counts are
// copied into shared memory at block start when they fit in 48 KB (Cornell
// is about 10 primitives, under 1 KB); larger scenes (a brute-force mesh
// pack of ~2.2k Havel columns is ~176 KB) are read from global memory
// through the read-only cache.
//
// Rounding follows the plain torch version (ops/cuda/bounce_kernel.py):
// no fused multiply-add (built with --fmad=false), true divisions, and
// sqrt, 1/sqrt, sin, cos, exp and log taken in double and rounded to
// float, the functions torch calls on float64 CUDA tensors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kFltEps = 1.1920929e-7f;
constexpr float kPlaneEps = 1e-3f;
constexpr float kTwoPi = 6.283185307179586f;

// Rows of each packed type (geometry + 8 material rows) and the row where
// the material rows start.
constexpr int kSphRows = 18, kSphMat = 10;
constexpr int kPlaRows = 21, kPlaMat = 13;
constexpr int kHavRows = 20, kHavMat = 12;
constexpr int kBoxRows = 23, kBoxMat = 15;

constexpr int kLambertian = 0, kMetal = 1, kDielectric = 2, kEmission = 3,
              kPhongMetal = 4, kSpecular = 5, kCoat = 6, kRefraction = 7;

constexpr int kFlagSky = 1, kFlagRR = 2, kFlagEmission = 4;

// Threads a CTA: K1's own, and K2's and K0's.
constexpr int kRenderThreads = 128;
constexpr int kThreads = 128;
// Lanes of a K1 or K2 warp that wait for a new path before they start it.
constexpr int kRegenLanes = 4;
// CTAs a SM that K2 with the walk is compiled for (80 registers a thread
// instead of 87-92: 6 CTAs instead of 5, 10-15% faster on the mesh;
// tools/walk_steps.py).
constexpr int kPathWalkCtas = 6;
constexpr unsigned kFull = 0xffffffffu;
// A column index above every real one: a walk partial without a hit.
constexpr int kNoColumn = 0x7fffffff;
constexpr int kSmemLimit = 48 * 1024;

__device__ __forceinline__ float sqrt_f(float x) { return sqrtf(x); }
__device__ __forceinline__ float rsqrt_f(float x) {
  return (float)(1.0 / sqrt((double)x));
}
__device__ __forceinline__ float sin_f(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos_f(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float exp_f(float x) { return (float)exp((double)x); }
__device__ __forceinline__ float log_f(float x) { return (float)log((double)x); }

__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d; b += c * a; c += a * b; d += b * c;
  a ^= a >> 16; b ^= b >> 16; c ^= c >> 16; d ^= d >> 16;
  a += b * d; b += c * a; c += a * b; d += b * c;
}

__device__ __forceinline__ float to_uniform(uint32_t u) {
  return (float)(int32_t)(u >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float inv = rsqrt_f(fmaxf(x * x + y * y + z * z, 1e-30f));
  x = x * inv; y = y * inv; z = z * inv;
}

struct Scene {
  const float* sph; const float* pla; const float* tri; const float* quad;
  const float* box;
  int ns, np, nt, nq, nb;
  // The tile-BVH of the mesh (kBvh): node boxes (6, n_nodes), node meta
  // (5, n_nodes: is_leaf, tile start, skip, tile_lo, tile_hi), each node's
  // real columns (n_nodes: a leaf's prefix of its tile, 0 for the others),
  // the Havel rows (20, trih_cols) in leaf-tile order and their 12
  // geometry rows column by column (trih_cols x 3 float4).
  const float* bvh_b; const int32_t* bvh_m; const int32_t* bvh_c;
  const float* trih; const float4* aos;
  int n_nodes, trih_cols;
};

struct Hit {
  float t, kind, nx, ny, nz, ar, ag, ab, par, er, eg, eb;
};

// Winner attributes from material rows starting at `m` (column stride n).
__device__ __forceinline__ void take_mat(Hit& h, const float* m, int n) {
  h.kind = m[0]; h.ar = m[n]; h.ag = m[2 * n]; h.ab = m[3 * n];
  h.par = m[4 * n]; h.er = m[5 * n]; h.eg = m[6 * n]; h.eb = m[7 * n];
}

__device__ __forceinline__ void havel(Hit& h, const float* rows, int n, int count,
                                      bool quad, float ox, float oy, float oz,
                                      float dx, float dy, float dz, float tmin) {
  for (int i = 0; i < count; ++i) {
    const float* H = rows + i;
    float nx = H[0], ny = H[n], nz = H[2 * n];
    float dn = dx * nx + dy * ny + dz * nz;
    bool ok = dn < -kFltEps;  // backface culling
    float inv = 1.0f / (ok ? dn : 1.0f);
    float t = (H[3 * n] - (ox * nx + oy * ny + oz * nz)) * inv;
    float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
    float u = H[4 * n] * hx + H[5 * n] * hy + H[6 * n] * hz + H[7 * n];
    float v = H[8 * n] * hx + H[9 * n] * hy + H[10 * n] * hz + H[11 * n];
    bool uv_ok = quad ? (u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f)
                      : (u >= 0.0f && v >= 0.0f && u + v <= 1.0f);
    if (ok && uv_ok && t > tmin && t < h.t) {
      h.t = t; h.nx = nx; h.ny = ny; h.nz = nz;
      take_mat(h, H + kHavMat * n, n);
    }
  }
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  return lt;
}

// The lane of the set bit of rank q (from 0) of `mask`, q < popc(mask).
__device__ __forceinline__ int lane_of(unsigned mask, int q) {
  if (mask == kFull) return q;
  int lane = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(mask & ((1u << w) - 1u));
    if (c <= q) { q -= c; mask >>= w; lane += w; }
  }
  return lane;
}

// The closest mesh hit through the tile-BVH, in front of h.t, walked by
// the lanes of `walkers` together (see the file comment). Every lane of
// `walkers` must call it, and no other lane.
__device__ __forceinline__ void bvh_closest(Hit& h, const Scene& s, unsigned walkers,
                                            float ox, float oy, float oz, float dx,
                                            float dy, float dz, float tmin) {
  const float eps_d = 1e-20f;
  const float sdx = fabsf(dx) < eps_d ? (dx >= 0.0f ? eps_d : -eps_d) : dx;
  const float sdy = fabsf(dy) < eps_d ? (dy >= 0.0f ? eps_d : -eps_d) : dy;
  const float sdz = fabsf(dz) < eps_d ? (dz >= 0.0f ? eps_d : -eps_d) : dz;
  const float ix = 1.0f / sdx, iy = 1.0f / sdy, iz = 1.0f / sdz;
  const int nn = s.n_nodes, n = s.trih_cols;
  const int lane = threadIdx.x & 31;
  const unsigned below = lanes_below();
  const int k = __popc(walkers);         // the walking lanes
  const int w = __popc(walkers & below);  // this lane's rank among them
  float best = h.t;
  int win = -1;
  int node = 0;  // the same in every walking lane
  while (node < nn) {
    const float* B = s.bvh_b + node;
    float t0 = (__ldg(B) - ox) * ix, t1 = (__ldg(B + 3 * nn) - ox) * ix;
    float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    t0 = (__ldg(B + nn) - oy) * iy; t1 = (__ldg(B + 4 * nn) - oy) * iy;
    tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
    t0 = (__ldg(B + 2 * nn) - oz) * iz; t1 = (__ldg(B + 5 * nn) - oz) * iz;
    tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
    const bool hit = tf >= tn && tf >= tmin && tn < best;
    const unsigned need = __ballot_sync(walkers, hit);
    const int32_t* M = s.bvh_m + node;
    if (need && __ldg(M) != 1) { ++node; continue; }
    if (need) {
      // S workers a needing ray: worker (r, c) = rank r * S + c among the
      // walkers scans columns c, c + S, ... of needing ray r.
      const int first = __ldg(M + nn), count = __ldg(s.bvh_c + node);
      const int m = __popc(need);
      const int log_s = 31 - __clz(k / m);
      const int S = 1 << log_s;
      const int r = w >> log_s;
      const bool working = r < m;
      const int src = lane_of(need, working ? r : 0);
      const float rox = __shfl_sync(walkers, ox, src);
      const float roy = __shfl_sync(walkers, oy, src);
      const float roz = __shfl_sync(walkers, oz, src);
      const float rdx = __shfl_sync(walkers, dx, src);
      const float rdy = __shfl_sync(walkers, dy, src);
      const float rdz = __shfl_sync(walkers, dz, src);
      float bt = __shfl_sync(walkers, best, src);
      int col = kNoColumn;
      if (working) {
        const float4* A = s.aos + (size_t)first * 3;
        for (int j = w & (S - 1); j < count; j += S) {
          const float4 g0 = __ldg(A + 3 * j);      // n.xyz, dc
          const float4 g1 = __ldg(A + 3 * j + 1);  // e1p, d1
          const float4 g2 = __ldg(A + 3 * j + 2);  // e2p, d2
          const float dn = rdx * g0.x + rdy * g0.y + rdz * g0.z;
          const bool ok = dn < -kFltEps;  // backface culling
          const float inv = 1.0f / (ok ? dn : 1.0f);
          const float t = (g0.w - (rox * g0.x + roy * g0.y + roz * g0.z)) * inv;
          const float hx = rox + t * rdx, hy = roy + t * rdy, hz = roz + t * rdz;
          const float u = g1.x * hx + g1.y * hy + g1.z * hz + g1.w;
          const float v = g2.x * hx + g2.y * hy + g2.z * hz + g2.w;
          if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin && t < bt) {
            bt = t;
            col = j;
          }
        }
      }
      // The lexicographic (t, column) minimum over a ray's S workers, whose
      // ranks differ in their low log_s bits only.
      for (int off = S >> 1; off > 0; off >>= 1) {
        const int other = w ^ off;
        const int from = other < k ? lane_of(walkers, other) : lane;
        const float ot = __shfl_sync(walkers, bt, from);
        const int oc = __shfl_sync(walkers, col, from);
        if (ot < bt || (ot == bt && oc < col)) {
          bt = ot;
          col = oc;
        }
      }
      // A needing lane takes its ray's result from the ray's first worker.
      const bool needs = (need >> lane) & 1u;
      const int from = needs ? lane_of(walkers, __popc(need & below) << log_s) : lane;
      const float rt = __shfl_sync(walkers, bt, from);
      const int rc = __shfl_sync(walkers, col, from);
      if (needs && rc != kNoColumn) {
        best = rt;
        win = first + rc;
      }
    }
    node = __ldg(M + 2 * nn);
  }
  if (win >= 0) {
    const float* H = s.trih + win;
    h.t = best;
    h.nx = H[0]; h.ny = H[n]; h.nz = H[2 * n];
    take_mat(h, H + kHavMat * n, n);
  }
}

template <bool kBvh>
__device__ Hit closest_hit(const Scene& s, float ox, float oy, float oz,
                           float dx, float dy, float dz, float tm, float tmin,
                           unsigned walkers) {
  Hit h;
  h.t = kBig; h.kind = -1.0f;
  h.nx = h.ny = h.nz = 0.0f;
  h.ar = h.ag = h.ab = h.par = h.er = h.eg = h.eb = 0.0f;
  float a = dx * dx + dy * dy + dz * dz;

  const int ns = s.ns;
  for (int i = 0; i < ns; ++i) {
    const float* S = s.sph + i;
    float w = (tm - S[6 * ns]) * S[7 * ns];
    float cx = S[0] + S[3 * ns] * w;
    float cy = S[ns] + S[4 * ns] * w;
    float cz = S[2 * ns] + S[5 * ns] * w;
    float r = S[8 * ns];
    float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    float half_b = ocx * dx + ocy * dy + ocz * dz;
    float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
    float disc = half_b * half_b - a * c;
    bool ok = disc > kFltEps;
    float sq = sqrt_f(ok ? disc : 1.0f);
    float inv_a = 1.0f / a;
    float r0 = (-half_b - sq) * inv_a;
    float r1 = (-half_b + sq) * inv_a;
    bool in0 = r0 >= tmin && r0 <= h.t;  // inclusive bound for spheres
    bool in1 = r1 >= tmin && r1 <= h.t;
    float t = in0 ? r0 : r1;
    if (ok && (in0 || in1)) {
      float inv_r = 1.0f / (r != 0.0f ? r : 1.0f);
      h.t = t;
      h.nx = (ox + t * dx - cx) * inv_r;
      h.ny = (oy + t * dy - cy) * inv_r;
      h.nz = (oz + t * dz - cz) * inv_r;
      take_mat(h, S + kSphMat * ns, ns);
    }
  }

  const int np = s.np;
  for (int i = 0; i < np; ++i) {
    const float* P = s.pla + i;
    float nx = P[3 * np], ny = P[4 * np], nz = P[5 * np];
    float denom = dx * nx + dy * ny + dz * nz;
    bool two_sided = P[12 * np] > 0.5f;
    bool gate = (fabsf(denom) > kPlaneEps && two_sided) ||
                (denom > kPlaneEps && !two_sided);
    float inv_den = 1.0f / (gate ? denom : 1.0f);
    float t = ((P[0] - ox) * nx + (P[np] - oy) * ny + (P[2 * np] - oz) * nz) * inv_den;
    float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
    bool inside = hx > P[6 * np] && hx < P[9 * np] && hy > P[7 * np] &&
                  hy < P[10 * np] && hz > P[8 * np] && hz < P[11 * np];
    if (gate && inside && t >= tmin && t < h.t) {
      h.t = t; h.nx = nx; h.ny = ny; h.nz = nz;
      take_mat(h, P + kPlaMat * np, np);
    }
  }

  if constexpr (kBvh) {
    bvh_closest(h, s, walkers, ox, oy, oz, dx, dy, dz, tmin);
    return h;
  }
  havel(h, s.tri, s.nt, s.nt, false, ox, oy, oz, dx, dy, dz, tmin);
  havel(h, s.quad, s.nq, s.nq, true, ox, oy, oz, dx, dy, dz, tmin);

  // Oriented boxes: slab test, entry face only (tn >= tmin); the normal is
  // the entry slab's outward axis.
  const int nb = s.nb;
  for (int i = 0; i < nb; ++i) {
    const float* B = s.box + i;
    const float eps_b = 1e-20f;
    float relx = ox - B[0], rely = oy - B[nb], relz = oz - B[2 * nb];
    float tn = -kBig, tf = kBig;
    float nxw = 0.0f, nyw = 0.0f, nzw = 0.0f;
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      float axx = B[(3 + 3 * axis) * nb];
      float axy = B[(4 + 3 * axis) * nb];
      float axz = B[(5 + 3 * axis) * nb];
      float hh = B[(12 + axis) * nb];
      float ol = relx * axx + rely * axy + relz * axz;
      float dl = dx * axx + dy * axy + dz * axz;
      float dls = fabsf(dl) < eps_b ? (dl >= 0.0f ? eps_b : -eps_b) : dl;
      float inv = 1.0f / dls;
      float t0 = (-hh - ol) * inv;
      float t1 = (hh - ol) * inv;
      float tna = fminf(t0, t1);
      float tfa = fmaxf(t0, t1);
      if (tna > tn) {
        float sg = dl >= 0.0f ? -1.0f : 1.0f;
        nxw = sg * axx; nyw = sg * axy; nzw = sg * axz;
      }
      tn = fmaxf(tn, tna);
      tf = fminf(tf, tfa);
    }
    if (tf >= tn && tn >= tmin && tn < h.t) {
      h.t = tn; h.nx = nxw; h.ny = nyw; h.nz = nzw;
      take_mat(h, B + kBoxMat * nb, nb);
    }
  }
  return h;
}

// Tangent-frame lobe about a unit axis with the shared azimuth.
__device__ __forceinline__ void frame_lobe(float ax, float ay, float az, float cos_t,
                                           float cos_phi, float sin_phi,
                                           float& gx, float& gy, float& gz) {
  float s = az >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (s + az);
  float b = ax * ay * a;
  float t0x = 1.0f + s * ax * ax * a, t0y = s * b, t0z = -s * ax;
  float t1x = b, t1y = s + ay * ay * a, t1z = -ay;
  float sin_t = sqrt_f(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  float cp = cos_phi * sin_t, sp = sin_phi * sin_t;
  gx = t0x * cp + t1x * sp + ax * cos_t;
  gy = t0y * cp + t1y * sp + ay * cos_t;
  gz = t0z * cp + t1z * sp + az * cos_t;
}

// The state of one path between bounces.
struct Path {
  float ox, oy, oz, dx, dy, dz;  // ray
  float tpx, tpy, tpz;           // throughput
  float rx, ry, rz;              // radiance
};

struct Flags {
  bool sky, rr, add_emission, lambertian_used;
};

__device__ __forceinline__ Flags decode_flags(int flags) {
  Flags f;
  f.sky = flags & kFlagSky;
  f.rr = flags & kFlagRR;
  f.add_emission = flags & kFlagEmission;
  f.lambertian_used = (flags >> 8) & (1 << kLambertian);
  return f;
}

// One bounce of a live path at shutter time `tm` with the bounce's four
// uniforms: closest hit, BSDF, radiance bookkeeping and, when `do_rr`,
// Russian roulette. Returns whether the path goes on. A path that ends
// keeps its ray; its throughput is the incoming one, times the
// attenuation when Russian roulette ended it (as the plain version's).
// With the tile-BVH walk, `walkers` are the lanes of the warp that call it
// together (unused without the walk).
template <bool kBvh>
__device__ __forceinline__ bool bounce(const Scene& s, Path& p, float tm,
                                       float v0, float v1, float v2, float v3,
                                       bool do_rr, const Flags& fl, float tmin,
                                       unsigned walkers) {
  const float ox = p.ox, oy = p.oy, oz = p.oz;
  const float dx = p.dx, dy = p.dy, dz = p.dz;
  Hit h = closest_hit<kBvh>(s, ox, oy, oz, dx, dy, dz, tm, tmin, walkers);
  const bool valid = h.kind >= 0.0f;
  const int kind = (int)h.kind;

  // Face the normal toward the ray.
  const bool front = dx * h.nx + dy * h.ny + dz * h.nz < kFltEps;
  const float sgn = front ? 1.0f : -1.0f;
  const float nx = h.nx * sgn, ny = h.ny * sgn, nz = h.nz * sgn;
  const float il = rsqrt_f(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
  const float ux = dx * il, uy = dy * il, uz = dz * il;

  bool scattered = kind != kEmission;
  float sdx = nx, sdy = ny, sdz = nz;
  float atr = h.ar, atg = h.ag, atb = h.ab;
  if (valid) {
    const float phi = kTwoPi * v1;
    const float cos_phi = cos_f(phi), sin_phi = sin_f(phi);
    const float u_dot_n = ux * nx + uy * ny + uz * nz;
    const float mx = ux - 2.0f * u_dot_n * nx;
    const float my = uy - 2.0f * u_dot_n * ny;
    const float mz = uz - 2.0f * u_dot_n * nz;
    const float az_z = 1.0f - 2.0f * v0;
    const float az_r = sqrt_f(fmaxf(0.0f, 1.0f - az_z * az_z));
    const float avx = az_r * cos_phi, avy = az_r * sin_phi, avz = az_z;

    switch (kind) {
      case kMetal: {
        float fuzz = fminf(h.par, 1.0f);
        float ballr = exp_f(log_f(fmaxf(v2, 1e-12f)) / 3.0f);
        float bx = avx * ballr, by = avy * ballr, bz = avz * ballr;
        float mrx = mx + fuzz * bx, mry = my + fuzz * by, mrz = mz + fuzz * bz;
        bool ok = (mrx * nx + mry * ny + mrz * nz) > 0.0f;
        sdx = ok ? mrx : mx; sdy = ok ? mry : my; sdz = ok ? mrz : mz;
        normalize3(sdx, sdy, sdz);
        float okf = ok ? 1.0f : 0.0f;
        atr = h.ar * okf; atg = h.ag * okf; atb = h.ab * okf;
        scattered = ok;
        break;
      }
      case kDielectric: {
        float ior = h.par > 0.0f ? h.par : 1.5f;
        float eta = front ? 1.0f / ior : ior;
        float cos_t = fminf(-(ux * nx + uy * ny + uz * nz), 1.0f);
        float sin_t = sqrt_f(fmaxf(0.0f, 1.0f - cos_t * cos_t));
        bool cannot = eta * sin_t > 1.0f;
        float r0s = (1.0f - eta) / (1.0f + eta);
        r0s = r0s * r0s;
        float omc = 1.0f - cos_t;
        float omc2 = omc * omc;
        float rp = r0s + (1.0f - r0s) * omc2 * omc2 * omc;
        bool choose = cannot || rp > v2;
        float px = eta * (ux + cos_t * nx);
        float py = eta * (uy + cos_t * ny);
        float pz = eta * (uz + cos_t * nz);
        float k = 1.0f - (px * px + py * py + pz * pz);
        float rpar = k > 0.0f ? sqrt_f(k) : 0.0f;
        sdx = choose ? mx : px - rpar * nx;
        sdy = choose ? my : py - rpar * ny;
        sdz = choose ? mz : pz - rpar * nz;
        normalize3(sdx, sdy, sdz);
        atr = atg = atb = 1.0f;
        break;
      }
      case kPhongMetal: {
        float pc = exp_f(log_f(fmaxf(v0, 1e-12f)) / (fmaxf(h.par, 0.0f) + 1.0f));
        float ax = mx, ay = my, az = mz;
        normalize3(ax, ay, az);
        frame_lobe(ax, ay, az, pc, cos_phi, sin_phi, sdx, sdy, sdz);
        break;
      }
      case kSpecular: {
        sdx = mx; sdy = my; sdz = mz;
        normalize3(sdx, sdy, sdz);
        break;
      }
      case kCoat: {
        bool spec = v2 < 0.05f;
        float ccos = sqrt_f(fmaxf(0.0f, 1.0f - v0));
        frame_lobe(nx, ny, nz, ccos, cos_phi, sin_phi, sdx, sdy, sdz);
        if (spec) { sdx = mx; sdy = my; sdz = mz; }
        float specf = spec ? 1.0f : 0.0f;
        atr = specf + (1.0f - specf) * h.ar;
        atg = specf + (1.0f - specf) * h.ag;
        atb = specf + (1.0f - specf) * h.ab;
        break;
      }
      case kRefraction: {
        float nt = h.par > 0.0f ? h.par : 1.5f;
        float nnt = front ? 1.0f / nt : nt;
        float ddn = ux * nx + uy * ny + uz * nz;
        float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
        bool tir = cos2t < 0.0f;
        float cos_t = fminf(-ddn, 1.0f);
        float px = nnt * (ux + cos_t * nx);
        float py = nnt * (uy + cos_t * ny);
        float pz = nnt * (uz + cos_t * nz);
        float k = 1.0f - (px * px + py * py + pz * pz);
        float rpar = k > 0.0f ? sqrt_f(k) : 0.0f;
        float tdx = px - rpar * nx, tdy = py - rpar * ny, tdz = pz - rpar * nz;
        normalize3(tdx, tdy, tdz);
        float q = (nt - 1.0f) / (nt + 1.0f);
        float r0s = q * q;
        float c1m = 1.0f - (front ? -ddn : tdx * nx + tdy * ny + tdz * nz);
        float c1m2 = c1m * c1m;
        float re = r0s + (1.0f - r0s) * c1m2 * c1m2 * c1m;
        float prob = 0.25f + 0.5f * re;
        bool choose = tir || v2 < prob;
        if (choose) {
          sdx = mx; sdy = my; sdz = mz;
          normalize3(sdx, sdy, sdz);
        } else {
          sdx = tdx; sdy = tdy; sdz = tdz;
        }
        float w = tir ? 1.0f : (choose ? re / prob : (1.0f - re) / (1.0f - prob));
        atr = h.ar * w; atg = h.ag * w; atb = h.ab * w;
        break;
      }
      case kEmission:
        break;  // terminates below
      default: {  // Lambertian (and any kind without its own lobe)
        if (fl.lambertian_used) {
          float lrx = nx + avx, lry = ny + avy, lrz = nz + avz;
          if (fabsf(lrx) < 1e-8f && fabsf(lry) < 1e-8f && fabsf(lrz) < 1e-8f) {
            lrx = nx; lry = ny; lrz = nz;
          }
          normalize3(lrx, lry, lrz);
          sdx = lrx; sdy = lry; sdz = lrz;
        }
        break;
      }
    }
  }

  // ---- radiance bookkeeping ----
  if (!valid) {
    if (fl.sky) {
      float t_sky = 0.5f * (uy + 1.0f);
      p.rx = p.rx + p.tpx * (1.0f + t_sky * (float)(0.5 - 1.0));
      p.ry = p.ry + p.tpy * (1.0f + t_sky * (float)(0.7 - 1.0));
      p.rz = p.rz + p.tpz * (1.0f + t_sky * (float)(1.0 - 1.0));
    }
    return false;
  }
  if (fl.add_emission) {
    p.rx = p.rx + p.tpx * h.er;
    p.ry = p.ry + p.tpy * h.eg;
    p.rz = p.rz + p.tpz * h.eb;
  }
  if (kind == kEmission) {
    p.rx = p.rx + p.tpx * h.ar * h.par;
    p.ry = p.ry + p.tpy * h.ag * h.par;
    p.rz = p.rz + p.tpz * h.ab * h.par;
  }
  if (!scattered) return false;
  p.tpx = p.tpx * atr; p.tpy = p.tpy * atg; p.tpz = p.tpz * atb;
  if (do_rr) {
    float pr = fminf(fmaxf(fmaxf(fmaxf(p.tpx, p.tpy), p.tpz), 0.05f), 1.0f);
    if (!(v3 < pr)) return false;
    float inv_p = 1.0f / pr;
    p.tpx = p.tpx * inv_p; p.tpy = p.tpy * inv_p; p.tpz = p.tpz * inv_p;
  }
  p.ox = ox + h.t * dx; p.oy = oy + h.t * dy; p.oz = oz + h.t * dz;
  p.dx = sdx; p.dy = sdy; p.dz = sdz;
  return true;
}

// The tile-BVH arguments every entry takes (null and zeros without one).
struct MeshArgs {
  const float* bvh_b; const int32_t* bvh_m; const int32_t* bvh_c;
  const float* trih; const float* aos;
  int n_nodes, trih_cols;
};

// The packed scene rows, copied into shared memory when they fit (see the
// file comment); every thread of the block must call this.
__device__ __forceinline__ Scene load_scene(const float* scene_g, float* smem,
                                            int ns, int np, int nt, int nq,
                                            int nb, int n_floats, int use_smem,
                                            const MeshArgs& mesh) {
  const float* base = scene_g;
  if (use_smem) {
    for (int k = threadIdx.x; k < n_floats; k += blockDim.x) smem[k] = scene_g[k];
    __syncthreads();
    base = smem;
  }
  Scene s;
  s.ns = ns; s.np = np; s.nt = nt; s.nq = nq; s.nb = nb;
  s.sph = base;
  s.pla = s.sph + kSphRows * ns;
  s.tri = s.pla + kPlaRows * np;
  s.quad = s.tri + kHavRows * nt;
  s.box = s.quad + kHavRows * nq;
  s.bvh_b = mesh.bvh_b; s.bvh_m = mesh.bvh_m; s.bvh_c = mesh.bvh_c;
  s.trih = mesh.trih; s.aos = (const float4*)mesh.aos;
  s.n_nodes = mesh.n_nodes; s.trih_cols = mesh.trih_cols;
  return s;
}

// The four uniforms of bounce `b` (0-based) of pixel `p`: pcg4d(p, b0,
// b + 1, b1).
__device__ __forceinline__ void bounce_uniforms(uint32_t p, uint32_t b0,
                                                uint32_t b1, int b, float& v0,
                                                float& v1, float& v2, float& v3) {
  uint32_t c0 = p, c1 = b0, c2 = (uint32_t)(b + 1), c3 = b1;
  pcg4d(c0, c1, c2, c3);
  v0 = to_uniform(c0); v1 = to_uniform(c1); v2 = to_uniform(c2); v3 = to_uniform(c3);
}

// The thin-lens primary ray of the sample with key words (b0, b1) through
// pixel p at (xs, ys) (models/camera.raygen), from the 21-float camera
// frame `f`, and the sample's shutter time.
__device__ __forceinline__ void primary_ray(const float* f, uint32_t p, float xs,
                                            float ys, uint32_t b0, uint32_t b1,
                                            int width, int height, Path& path,
                                            float& tm) {
  uint32_t h0 = p, h1 = b0, h2 = 0x9E3779B9u, h3 = b1;
  pcg4d(h0, h1, h2, h3);
  float u0 = to_uniform(h0), u1 = to_uniform(h1), u2 = to_uniform(h2),
        u3 = to_uniform(h3);
  uint32_t g0 = p, g1 = b0, g2 = 0x85EBCA6Bu, g3 = b1;
  pcg4d(g0, g1, g2, g3);
  float u4 = to_uniform(g0);
  float dxs = (xs + u0) / (float)(width - 1);
  float dys = (ys + u1) / (float)(height - 1);
  float lr = sqrt_f(u2);
  float lphi = kTwoPi * u3;
  float disk_x = f[18] * lr * cos_f(lphi);
  float disk_y = f[18] * lr * sin_f(lphi);
  path.ox = f[0] + disk_x * f[12] + disk_y * f[15];
  path.oy = f[1] + disk_x * f[13] + disk_y * f[16];
  path.oz = f[2] + disk_x * f[14] + disk_y * f[17];
  float dx = f[3] + dxs * f[6] + dys * f[9] - path.ox;
  float dy = f[4] + dxs * f[7] + dys * f[10] - path.oy;
  float dz = f[5] + dxs * f[8] + dys * f[11] - path.oz;
  float nsq = dx * dx + dy * dy + dz * dz;
  float ninv = nsq > 0.0f ? 1.0f / sqrt_f(nsq) : 0.0f;
  path.dx = dx * ninv; path.dy = dy * ninv; path.dz = dz * ninv;
  tm = u4 * (f[20] - f[19]) + f[19];
  path.tpx = path.tpy = path.tpz = 1.0f;
  path.rx = path.ry = path.rz = 0.0f;
}

// K1: raygen plus every sample and bounce of one pixel per thread, with
// path regeneration: each thread runs one loop over bounce steps and starts
// its pixel's next sample when its current path has ended, so the lanes of
// a warp run the bounce body together instead of idling until the longest
// path of each sample has ended. The raygen step diverges from the bounce,
// so a warp's lanes without a path start their next samples together, once
// kRegenLanes of them wait (or no lane has a path). Per pixel the samples,
// their bounces and the sums are the same arithmetic in the same order as
// the plain version.
template <bool kBvh>
__global__ void __launch_bounds__(kRenderThreads)
render_kernel(const float* __restrict__ scene_g, int ns, int np, int nt, int nq,
              int nb, int n_floats, int use_smem, MeshArgs mesh,
              const float* __restrict__ frame,
              const uint32_t* __restrict__ words, int n_samples,
              const int32_t* __restrict__ pid_g, int n, int width, int height,
              int bounces, int rr_start, float tmin, int flags,
              float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float f[21];  // the camera frame, out of the threads' registers
  if (threadIdx.x < 21) f[threadIdx.x] = frame[threadIdx.x];
  const Scene s = load_scene(scene_g, smem, ns, np, nt, nq, nb, n_floats, use_smem,
                             mesh);
  __syncthreads();  // the frame (load_scene waits only when it stages rows)
  // Every lane of a warp takes part in its votes: a lane past the last
  // pixel has no sample to run.
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  const Flags fl = decode_flags(flags);

  const uint32_t p = valid ? (uint32_t)pid_g[i] : 0u;
  const float xs = (float)(p % (uint32_t)width);
  const float ys = (float)(p / (uint32_t)width);
  float arx = 0.0f, ary = 0.0f, arz = 0.0f;

  Path path;
  float tm = 0.0f;
  uint32_t b0 = 0u, b1 = 0u;
  int smp = valid && bounces > 0 ? 0 : n_samples;  // the next sample to start
  int b = 0;
  bool busy = false;  // a path is under way
  for (;;) {
    const bool wait = !busy && smp < n_samples;
    const unsigned waiting = __ballot_sync(kFull, wait);
    const unsigned tracing = __ballot_sync(kFull, busy);
    if (!(waiting | tracing)) break;
    if (wait && (!tracing || __popc(waiting) >= kRegenLanes)) {
      b0 = words[2 * smp];
      b1 = words[2 * smp + 1];
      primary_ray(f, p, xs, ys, b0, b1, width, height, path, tm);
      b = 0;
      busy = true;
    }
    // The lanes that trace this step walk the tile-BVH together.
    const unsigned walkers = kBvh ? __ballot_sync(kFull, busy) : 0u;
    if (busy) {
      float v0, v1, v2, v3;
      bounce_uniforms(p, b0, b1, b, v0, v1, v2, v3);
      const bool cont = bounce<kBvh>(s, path, tm, v0, v1, v2, v3,
                                     fl.rr && b >= rr_start, fl, tmin, walkers);
      ++b;
      if (!cont || b == bounces) {
        arx = arx + path.rx; ary = ary + path.ry; arz = arz + path.rz;
        ++smp;
        busy = false;
      }
    }
  }
  if (!valid) return;
  out[3 * i + 0] = arx;
  out[3 * i + 1] = ary;
  out[3 * i + 2] = arz;
}

// K2: the whole bounce loop of supplied rays, one sample's key words (b0,
// b1) for the wavefront, on a persistent grid with path regeneration. Each
// warp owns a contiguous range of the rays (its share of [0, n), so a
// warp's rays stay neighbours); a lane whose path has ended takes the
// range's next ray, and the waiting lanes start their rays together, once
// kRegenLanes of them wait or no lane traces (K1's vote). Ray i's radiance
// goes to out[3 * i] whichever lane traced it, and its draws depend on
// (pid[i], b0, b1, bounce) only.
template <bool kBvh>
__global__ void __launch_bounds__(kThreads, kBvh ? kPathWalkCtas : 1)
path_kernel(const float* __restrict__ scene_g, int ns, int np, int nt, int nq,
            int nb, int n_floats, int use_smem, MeshArgs mesh,
            const float* __restrict__ origin,
            const float* __restrict__ direction, const float* __restrict__ time,
            const int32_t* __restrict__ pid_g, uint32_t b0, uint32_t b1, int n,
            int bounces, int rr_start, float tmin, int flags,
            float* __restrict__ out) {
  extern __shared__ float smem[];
  const Scene s = load_scene(scene_g, smem, ns, np, nt, nq, nb, n_floats, use_smem,
                             mesh);
  const Flags fl = decode_flags(flags);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const long long wid = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int hi = (int)((wid + 1) * n / warps);
  int next = (int)(wid * n / warps);  // the range's first ray not yet started
  if (bounces <= 0) {
    for (int j = next + lane; j < hi; j += 32)
      out[3 * j] = out[3 * j + 1] = out[3 * j + 2] = 0.0f;
    return;
  }
  const unsigned below = lanes_below();
  Path path;
  float tm = 0.0f;
  uint32_t p = 0u;
  int i = 0, b = 0;
  bool busy = false;  // a path is under way
  for (;;) {
    const unsigned idle = __ballot_sync(kFull, !busy);
    const int left = hi - next;  // the same in every lane
    if (left <= 0 && idle == kFull) break;
    if (left > 0 && (idle == kFull || __popc(idle) >= kRegenLanes)) {
      const int q = __popc(idle & below);
      if (!busy && q < left) {
        i = next + q;
        p = (uint32_t)pid_g[i];
        path.ox = origin[3 * i]; path.oy = origin[3 * i + 1];
        path.oz = origin[3 * i + 2];
        path.dx = direction[3 * i]; path.dy = direction[3 * i + 1];
        path.dz = direction[3 * i + 2];
        tm = time[i];
        path.tpx = path.tpy = path.tpz = 1.0f;
        path.rx = path.ry = path.rz = 0.0f;
        b = 0;
        busy = true;
      }
      next += min(__popc(idle), left);
    }
    // The lanes that trace this step walk the tile-BVH together.
    const unsigned walkers = kBvh ? __ballot_sync(kFull, busy) : 0u;
    if (busy) {
      float v0, v1, v2, v3;
      bounce_uniforms(p, b0, b1, b, v0, v1, v2, v3);
      const bool cont = bounce<kBvh>(s, path, tm, v0, v1, v2, v3,
                                     fl.rr && b >= rr_start, fl, tmin, walkers);
      ++b;
      if (!cont || b == bounces) {
        out[3 * i + 0] = path.rx;
        out[3 * i + 1] = path.ry;
        out[3 * i + 2] = path.rz;
        busy = false;
      }
    }
  }
}

// K0's planar carry as row pointers, each row (n,) float32: the 13 input
// rows ox oy oz dx dy dz tm tpx tpy tpz rx ry rz, and the 12 output rows
// (the same without tm).
struct Carry {
  const float* in[13];
  float* out[12];
};

// One ray of K0: its carry, alive flag and the bounce's four uniforms.
struct StepRay {
  Path p;
  float tm;
  bool live;
  float4 u;
};

__device__ __forceinline__ void load_step(const Carry& c, const int32_t* alive,
                                          const float4* u4, int i, StepRay& r) {
  r.p.ox = __ldg(c.in[0] + i); r.p.oy = __ldg(c.in[1] + i);
  r.p.oz = __ldg(c.in[2] + i);
  r.p.dx = __ldg(c.in[3] + i); r.p.dy = __ldg(c.in[4] + i);
  r.p.dz = __ldg(c.in[5] + i);
  r.tm = __ldg(c.in[6] + i);
  r.p.tpx = __ldg(c.in[7] + i); r.p.tpy = __ldg(c.in[8] + i);
  r.p.tpz = __ldg(c.in[9] + i);
  r.p.rx = __ldg(c.in[10] + i); r.p.ry = __ldg(c.in[11] + i);
  r.p.rz = __ldg(c.in[12] + i);
  r.live = __ldg(alive + i) != 0;
  r.u = __ldg(u4 + i);
}

__device__ __forceinline__ void store_step(const Carry& c, int32_t* alive_out, int i,
                                           const Path& p, bool cont) {
  c.out[0][i] = p.ox; c.out[1][i] = p.oy; c.out[2][i] = p.oz;
  c.out[3][i] = p.dx; c.out[4][i] = p.dy; c.out[5][i] = p.dz;
  c.out[6][i] = p.tpx; c.out[7][i] = p.tpy; c.out[8][i] = p.tpz;
  c.out[9][i] = p.rx; c.out[10][i] = p.ry; c.out[11][i] = p.rz;
  alive_out[i] = cont ? 1 : 0;
}

// K0: one bounce over the planar carry `c`, one ray a thread, with the
// uniforms `u4` (n, float4) and the continue flag written to `alive_out`.
// Dead rays pass through with alive 0. With the tile-BVH walk every lane of
// a warp stays for the vote on who walks, those past n included.
//
// What bounds it is the bounce's own work, not its 124 bytes a ray
// (tools/k0_steps.py on an H100 SXM at 700 W, PERF.md): on the 262,144-ray
// Cornell wavefront the bounce alone, run again on loaded rays with nothing
// stored, takes 23 µs a launch, against 5.6-5.9 µs for the same reads and
// writes without it (12.6-12.8 µs from a cold L2) and a 9.7 µs bytes bound;
// the whole kernel takes 26.5-27.2 µs. So overlapping loads with bounces
// has at most 4 µs to gain, and a persistent grid that copies each
// thread's next ray into shared memory (cp.async) during the current
// bounce was slower (29.5-30.7 µs): the two waves of one ray a thread that
// the card schedules CTA by CTA overlap them already. K0 keeps that grid,
// takes the carry as row pointers (no stack of the rows before a launch)
// and reads the uniforms as one float4.
template <bool kBvh>
__global__ void __launch_bounds__(kThreads)
bounce_kernel(const float* __restrict__ scene_g, int ns, int np, int nt, int nq,
              int nb, int n_floats, int use_smem, MeshArgs mesh, Carry c,
              const int32_t* __restrict__ alive, const float4* __restrict__ u4,
              int n, int do_rr, float tmin, int flags,
              int32_t* __restrict__ alive_out) {
  extern __shared__ float smem[];
  const Scene s = load_scene(scene_g, smem, ns, np, nt, nq, nb, n_floats, use_smem,
                             mesh);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (!kBvh && i >= n) return;
  const bool in = i < n;
  const Flags fl = decode_flags(flags);
  StepRay r;
  r.live = false;
  if (in) load_step(c, alive, u4, i, r);
  // The live rays walk the tile-BVH together.
  const unsigned walkers = kBvh ? __ballot_sync(kFull, r.live) : 0u;
  bool cont = false;
  if (r.live)
    cont = bounce<kBvh>(s, r.p, r.tm, r.u.x, r.u.y, r.u.z, r.u.w,
                        fl.rr && do_rr != 0, fl, tmin, walkers);
  if (in) store_step(c, alive_out, i, r.p, cont);
}

// Shared-memory use of a launch: the scene rows when they fit in 48 KB.
int scene_floats(int n_sph, int n_pla, int n_trih, int n_quad, int n_box) {
  return kSphRows * n_sph + kPlaRows * n_pla + kHavRows * n_trih +
         kHavRows * n_quad + kBoxRows * n_box;
}

size_t smem_bytes(int n_floats) {
  const size_t bytes = (size_t)n_floats * sizeof(float);
  return bytes <= (size_t)kSmemLimit ? bytes : 0;
}

// CTAs of `kernel` resident on one SM at `threads` a CTA and `bytes` of
// shared memory, and the SMs of the current device.
int residency(const void* kernel, int threads, size_t bytes, int* ctas, int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads,
                                                             bytes);
  return err;
}

}  // namespace

extern "C" int rtnw_render_samples(const float* scene, int n_sph, int n_pla,
                                   int n_trih, int n_quad, int n_box,
                                   const float* bvh_b, const int32_t* bvh_m,
                                   const int32_t* bvh_c, const float* trih,
                                   const float* aos, int n_nodes, int trih_cols,
                                   const float* frame, const uint32_t* words,
                                   int n_samples, const int32_t* pid, int n,
                                   int width, int height, int bounces,
                                   int rr_start, float tmin, int flags, float* out,
                                   void* stream) {
  const int n_floats = scene_floats(n_sph, n_pla, n_trih, n_quad, n_box);
  const size_t bytes = smem_bytes(n_floats);
  const int blocks = (n + kRenderThreads - 1) / kRenderThreads;
  const MeshArgs mesh{bvh_b, bvh_m, bvh_c, trih, aos, n_nodes, trih_cols};
  auto kernel = n_nodes > 0 ? render_kernel<true> : render_kernel<false>;
  kernel<<<blocks, kRenderThreads, bytes, (cudaStream_t)stream>>>(
      scene, n_sph, n_pla, n_trih, n_quad, n_box, n_floats, bytes > 0 ? 1 : 0,
      mesh, frame, words, n_samples, pid, n, width, height, bounces, rr_start,
      tmin, flags, out);
  return (int)cudaGetLastError();
}

// K2's grid is persistent: the CTAs that fit on the card at once, or fewer
// when the rays fill fewer.
extern "C" int rtnw_path_trace(const float* scene, int n_sph, int n_pla,
                               int n_trih, int n_quad, int n_box,
                               const float* bvh_b, const int32_t* bvh_m,
                               const int32_t* bvh_c, const float* trih,
                               const float* aos, int n_nodes, int trih_cols,
                               const float* origin, const float* direction,
                               const float* time, const int32_t* pid, uint32_t b0,
                               uint32_t b1, int n, int bounces, int rr_start,
                               float tmin, int flags, float* out, void* stream) {
  const int n_floats = scene_floats(n_sph, n_pla, n_trih, n_quad, n_box);
  const size_t bytes = smem_bytes(n_floats);
  const MeshArgs mesh{bvh_b, bvh_m, bvh_c, trih, aos, n_nodes, trih_cols};
  auto kernel = n_nodes > 0 ? path_kernel<true> : path_kernel<false>;
  int ctas = 0, sms = 0;
  const int err = residency((const void*)kernel, kThreads, bytes, &ctas, &sms);
  if (err != 0) return err;
  const int fill = (n + kThreads - 1) / kThreads, resident = (ctas > 0 ? ctas : 1) * sms;
  const int blocks = fill < resident ? fill : resident;
  kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      scene, n_sph, n_pla, n_trih, n_quad, n_box, n_floats, bytes > 0 ? 1 : 0,
      mesh, origin, direction, time, pid, b0, b1, n, bounces, rr_start, tmin,
      flags, out);
  return (int)cudaGetLastError();
}

// `rows_in` and `rows_out` are host arrays of the carry's 13 input and 12
// output row pointers (see Carry).
extern "C" int rtnw_bounce_step(const float* scene, int n_sph, int n_pla,
                                int n_trih, int n_quad, int n_box,
                                const float* bvh_b, const int32_t* bvh_m,
                                const int32_t* bvh_c, const float* trih,
                                const float* aos, int n_nodes, int trih_cols,
                                const float* const* rows_in,
                                float* const* rows_out, const int32_t* alive,
                                const float* u4, int n, int do_rr, float tmin,
                                int flags, int32_t* alive_out, void* stream) {
  Carry c;
  for (int k = 0; k < 13; ++k) c.in[k] = rows_in[k];
  for (int k = 0; k < 12; ++k) c.out[k] = rows_out[k];
  const int n_floats = scene_floats(n_sph, n_pla, n_trih, n_quad, n_box);
  const size_t bytes = smem_bytes(n_floats);
  const int blocks = (n + kThreads - 1) / kThreads;
  const MeshArgs mesh{bvh_b, bvh_m, bvh_c, trih, aos, n_nodes, trih_cols};
  auto kernel = n_nodes > 0 ? bounce_kernel<true> : bounce_kernel<false>;
  kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      scene, n_sph, n_pla, n_trih, n_quad, n_box, n_floats, bytes > 0 ? 1 : 0,
      mesh, c, alive, (const float4*)u4, n, do_rr, tmin, flags, alive_out);
  return (int)cudaGetLastError();
}

// CTAs resident on one SM of K1 (kernel 0), K2 (1) or K0 (2), with the
// tile-BVH walk or without, at a launch's shared memory, and its threads a
// CTA.
extern "C" int rtnw_render_occupancy(int kernel, int bvh, int n_sph, int n_pla,
                                     int n_trih, int n_quad, int n_box, int* ctas,
                                     int* threads) {
  const size_t bytes = smem_bytes(scene_floats(n_sph, n_pla, n_trih, n_quad, n_box));
  const void* fn = nullptr;
  *threads = kThreads;
  switch (kernel) {
    case 0:
      fn = bvh ? (const void*)render_kernel<true> : (const void*)render_kernel<false>;
      *threads = kRenderThreads;
      break;
    case 1:
      fn = bvh ? (const void*)path_kernel<true> : (const void*)path_kernel<false>;
      break;
    case 2:
      fn = bvh ? (const void*)bounce_kernel<true> : (const void*)bounce_kernel<false>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, *threads, bytes);
}

extern "C" const char* rtnw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
