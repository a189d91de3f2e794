// The sorted wavefront's shading, for Hopper (sm_90a): all that a bounce of
// models/integrator._trace_sorted does after K4, in one launch.
//
// Replaces no TPU kernel: the JAX package runs these steps as XLA ops
// (raytracingthenextweekcuda_tpu/models/integrator.py:360, _bounce_body, and
// ops/fused.py:35, intersect_scene_fused), and so did the port, with about
// 480 torch launches a bounce, which are now this kernel's plain version
// (ops/cuda/shade_kernel.py shade_reference). It was added because those
// launches, each a few float operations a ray, set the mesh path's pace:
// their device time and the host's time to enqueue them.
//
// One thread a ray. For a live ray the thread
//  1. merges K3's analytic winner (t_sel, code) with K4's mesh winner
//     (t_m, c_m): the mesh wins only when strictly closer, or when there is
//     no analytic hit (ops/fused.merge);
//  2. recomputes the winner's hit record from its row of the scene's
//     tables: the moving sphere's centre and its root closer to t_sel, the
//     plane's t, the triangle's t and normalized cross normal, and the
//     normal facing the ray (ops/fused._recompute);
//  3. reads the material row and draws the bounce's pcg4d uniforms from
//     the ray's slot (its pixel and its sample's key words, rng.SlotCtx);
//  4. scatters by the material kind, for the kinds the scene uses
//     (ops/materials.scatter): a kind that is not used takes the default
//     lobe, as the plain version's select chain leaves it;
//  5. adds the sky or the emission to the radiance, updates the throughput,
//     plays Russian roulette and writes the next ray and whether it lives
//     (models/integrator._shade).
// A dead ray keeps its ray and throughput, and its radiance gets the plain
// version's three zero terms.
//
// What bounds it on this card: bytes, about 126 a ray (the state, both
// winners and the slot read once, the new state written once); the scene's
// and the materials' rows are read through the cache. The float64 functions
// (sqrt, sin, cos, pow) are a few hundred float64 operations a ray, under
// the bytes' time at the FP64 rate. The design keeps every intermediate of
// the plain version in registers and issues one launch where it issues
// about 480.
//
// Equal to the plain version on the card bit for bit. Rounding follows the
// torch ops one by one: no fused multiply-add (built with --fmad=false),
// true divisions (torch divides by a tensor, and `1.0 / x` is its
// reciprocal, a true division, times 1), sums of three products in the
// plain version's order, float32 scalars as torch casts them, clamps and
// maxima that keep NaN as torch's do, and sqrt, sin, cos and pow taken in
// double and rounded to float, the functions torch calls on float64 CUDA
// tensors (ops/fmath.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFltEps = 1.1920929e-7f;
constexpr float kTwoPi = 6.283185307179586f;

// Winner types of the codes (type << 24 | index) and the recompute tables'
// columns: spheres c0, c1, time0, time1, radius, material; planes position,
// normal, material; triangles three vertices, material.
constexpr int kSphere = 1, kPlane = 2, kTriangle = 3;
constexpr int kSphCols = 10, kPlaCols = 7, kTriCols = 10;

constexpr int kLambertian = 0, kMetal = 1, kDielectric = 2, kEmission = 3,
              kPhongMetal = 4, kSpecular = 5, kCoat = 6, kRefraction = 7;

// flags: bit 0 the sky on a miss, bit 1 Russian roulette at this bounce;
// bits 8-15 the material kinds the scene uses.
constexpr int kFlagSky = 1, kFlagRR = 2;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ops/fmath.py: float64 functions rounded to float32.
__device__ __forceinline__ float sqrt64(float x) { return (float)sqrt((double)x); }
__device__ __forceinline__ float sin64(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos64(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float pow64(float x, double y) { return (float)pow((double)x, y); }

// torch.clamp_min, torch.clamp_max: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }

// A maximum that is NaN when either operand is (torch.amax).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// ops/linalg.normalize: the zero vector maps to zero.
__device__ __forceinline__ V3 normalize(V3 v) {
  const float ns = dot(v, v);
  const bool pos = ns > 0.0f;
  const float inv = pos ? 1.0f / sqrt64(ns) : 0.0f;
  return scale(v, inv);
}

// ops/linalg.reflect: v - (2 dot(v, n)) n.
__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return sub(v, scale(n, 2.0f * dot(v, n))); }

// ops/linalg.refract.
__device__ __forceinline__ V3 refract(V3 uv, V3 n, float eta) {
  const float ct = clamp_max(dot(neg(uv), n), 1.0f);
  const V3 perp = scale(add(uv, scale(n, ct)), eta);
  const float k = 1.0f - dot(perp, perp);
  const float r_par = k > 0.0f ? sqrt64(k) : 0.0f;
  return sub(perp, scale(n, r_par));
}

// ops/materials.scatter's azimuth_vec: (r cos phi, r sin phi, z).
__device__ __forceinline__ V3 azimuth_vec(float z, float cos_phi, float sin_phi) {
  const float r = sqrt64(clamp_min(1.0f - z * z, 0.0f));
  return {r * cos_phi, r * sin_phi, z};
}

// ops/materials.scatter's frame_lobe over ops/sampling.orthonormal_basis.
__device__ __forceinline__ V3 frame_lobe(V3 ax, float cos_t, float cos_phi,
                                         float sin_phi) {
  const float sign = ax.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + ax.z);
  const float b = ax.x * ax.y * a;
  const V3 t = {1.0f + sign * ax.x * ax.x * a, sign * b, -sign * ax.x};
  const V3 bb = {b, sign + ax.y * ax.y * a, -ax.y};
  const float sin_t = sqrt64(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const float cs = cos_phi * sin_t, ss = sin_phi * sin_t;
  return {t.x * cs + bb.x * ss + ax.x * cos_t, t.y * cs + bb.y * ss + ax.y * cos_t,
          t.z * cs + bb.z * ss + ax.z * cos_t};
}

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

struct ShadeArgs {
  const float* origin; const float* direction; const float* time;
  const float* throughput; const float* radiance; const unsigned char* alive;
  const float* t_sel; const int32_t* code;  // K3's winners
  const float* t_m; const int32_t* c_m;     // K4's, or null
  const int64_t* slot;                      // each ray's wavefront slot
  const int64_t* pixel;                     // pixel table, or null: s % n_div
  const int64_t* base0; const int64_t* base1;  // key words by s / m_div
  long long n_div, m_div;
  const float* spheres; const float* planes; const float* triangles;
  int n_sph, n_pla, n_tri;
  const int64_t* mat_kind; const float* mat_albedo; const float* mat_param;
  const float* mat_emission;
  int n, bounce, flags;
  float* origin_out; float* direction_out; float* throughput_out;
  float* radiance_out; unsigned char* alive_out;
};

// The hit record of a valid winner (ops/fused._recompute): t, the outward
// normal and the material row. A type whose table is empty leaves t at
// +inf, the normal zero and the row -1, as the plain version's masks do.
__device__ __forceinline__ void recompute(const ShadeArgs& a, int i, V3 o, V3 d,
                                          float t_sel, int code, float& t,
                                          V3& outward, long long& mat_id) {
  const int ptype = code >> 24;
  const int idx = code & 0xFFFFFF;
  t = __int_as_float(0x7f800000);
  outward = {0.0f, 0.0f, 0.0f};
  mat_id = -1;
  if (ptype == kSphere && a.n_sph > 0) {
    const float* r = a.spheres + (size_t)idx * kSphCols;
    const V3 c0 = {r[0], r[1], r[2]}, c1 = {r[3], r[4], r[5]};
    const float t0 = r[6], t1 = r[7], radius = r[8];
    const float w = (a.time[i] - t0) / (t1 - t0);
    const V3 center = add(c0, scale(sub(c1, c0), w));
    const V3 oc = sub(o, center);
    const float qa = dot(d, d);
    const float half_b = dot(oc, d);
    const float c = dot(oc, oc) - radius * radius;
    const float disc = clamp_min(half_b * half_b - qa * c, 0.0f);
    const float sq = disc > 0.0f ? sqrt64(disc) : 0.0f;
    const float r0 = (-half_b - sq) / qa;
    const float r1 = (-half_b + sq) / qa;
    const float ts = fabsf(r0 - t_sel) <= fabsf(r1 - t_sel) ? r0 : r1;
    const V3 p = add(o, scale(d, ts));
    t = ts;
    outward = {(p.x - center.x) / radius, (p.y - center.y) / radius,
               (p.z - center.z) / radius};
    mat_id = __float2ll_rn(r[9]);
  } else if (ptype == kPlane && a.n_pla > 0) {
    const float* r = a.planes + (size_t)idx * kPlaCols;
    const V3 pos = {r[0], r[1], r[2]}, nrm = {r[3], r[4], r[5]};
    float denom = dot(nrm, d);
    denom = fabsf(denom) > 1e-12f ? denom : 1.0f;
    t = dot(sub(pos, o), nrm) / denom;
    outward = nrm;
    mat_id = __float2ll_rn(r[6]);
  } else if (ptype == kTriangle && a.n_tri > 0) {
    const float* r = a.triangles + (size_t)idx * kTriCols;
    const V3 v0 = {r[0], r[1], r[2]};
    const V3 e1 = sub({r[3], r[4], r[5]}, v0);
    const V3 e2 = sub({r[6], r[7], r[8]}, v0);
    const float det = dot(e1, cross(d, e2));
    const float inv_det = 1.0f / (fabsf(det) > kFltEps ? det : 1.0f);
    t = dot(e2, cross(sub(o, v0), e1)) * inv_det;
    outward = normalize(cross(e1, e2));
    mat_id = __float2ll_rn(r[9]);
  }
}

struct Scatter {
  V3 dir, atten, emitted;
  bool scattered;
};

// Whether kind k is among the kinds in `used` (a bit per kind).
__device__ __forceinline__ bool uses(unsigned used, int k) {
  return k >= 0 && k < 8 && ((used >> k) & 1u);
}

// ops/materials.scatter for one ray of material kind `kind` at a hit with
// the normal facing the ray; `used` holds a bit per kind the scene uses.
__device__ __forceinline__ Scatter scatter(V3 d, V3 normal, bool front, int kind,
                                           V3 albedo, float param, float u0,
                                           float u1, float u2, unsigned used) {
  const V3 ud = normalize(d);
  const V3 mirror = reflect(ud, normal);
  const float phi = kTwoPi * u1;
  const float cos_phi = cos64(phi), sin_phi = sin64(phi);
  const V3 ones = {1.0f, 1.0f, 1.0f};
  Scatter s;
  s.atten = albedo;
  s.scattered = kind != kEmission;
  s.emitted = {0.0f, 0.0f, 0.0f};
  const bool own = uses(used, kind) && (kind == kMetal || kind == kDielectric ||
                                 kind == kPhongMetal || kind == kSpecular ||
                                 kind == kCoat || kind == kRefraction);
  if (!own) {
    if (uses(used, kLambertian)) {
      const V3 raw = add(normal, azimuth_vec(1.0f - 2.0f * u0, cos_phi, sin_phi));
      const bool near_zero = fabsf(raw.x) < 1e-8f && fabsf(raw.y) < 1e-8f &&
                             fabsf(raw.z) < 1e-8f;
      s.dir = normalize(pick(near_zero, normal, raw));
    } else {
      s.dir = normal;
    }
    if (kind == kEmission && uses(used, kEmission)) s.emitted = scale(albedo, param);
    return s;
  }
  switch (kind) {
    case kMetal: {
      const float fuzz = clamp_max(param, 1.0f);
      const V3 ball = scale(azimuth_vec(1.0f - 2.0f * u0, cos_phi, sin_phi),
                            pow64(clamp_min(u2, 1e-12f), 1.0 / 3.0));
      const V3 raw = add(mirror, scale(ball, fuzz));
      const bool ok = dot(raw, normal) > 0.0f;
      s.dir = normalize(pick(ok, raw, mirror));
      s.atten = scale(albedo, ok ? 1.0f : 0.0f);
      s.scattered = ok;
      break;
    }
    case kDielectric: {
      const float ior = param > 0.0f ? param : 1.5f;
      const float eta = front ? 1.0f / ior : ior;
      const float cos_t = clamp_max(dot(neg(ud), normal), 1.0f);
      const float sin_t = sqrt64(clamp_min(1.0f - cos_t * cos_t, 0.0f));
      const bool cannot_refract = eta * sin_t > 1.0f;
      float r0 = (1.0f - eta) / (1.0f + eta);
      r0 = r0 * r0;
      const float schlick = r0 + (1.0f - r0) * pow64(1.0f - cos_t, 5.0);
      const bool reflect_it = cannot_refract || schlick > u2;
      s.dir = normalize(pick(reflect_it, mirror, refract(ud, normal, eta)));
      s.atten = ones;
      break;
    }
    case kPhongMetal: {
      const float e = 1.0f / (clamp_min(param, 0.0f) + 1.0f);
      const float pc = pow64(clamp_min(u0, 1e-12f), (double)e);
      s.dir = frame_lobe(normalize(mirror), pc, cos_phi, sin_phi);
      break;
    }
    case kSpecular:
      s.dir = normalize(mirror);
      break;
    case kCoat: {
      const bool spec = u2 < 0.05f;
      const V3 diff = frame_lobe(normal, sqrt64(clamp_min(1.0f - u0, 0.0f)),
                                 cos_phi, sin_phi);
      s.dir = pick(spec, mirror, diff);
      s.atten = pick(spec, ones, albedo);
      break;
    }
    default: {  // kRefraction
      const float nt = param > 0.0f ? param : 1.5f;
      const float nnt = front ? 1.0f / nt : nt;
      const float ddn = dot(ud, normal);
      const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
      const bool tir = cos2t < 0.0f;
      const V3 tdir = normalize(refract(ud, normal, nnt));
      const float q = (nt - 1.0f) / (nt + 1.0f);
      const float r0 = q * q;
      const float c1m = 1.0f - (front ? -ddn : dot(tdir, normal));
      const float c1m2 = c1m * c1m;
      const float re = r0 + (1.0f - r0) * (c1m2 * c1m2 * c1m);
      const float prob = 0.25f + 0.5f * re;
      const bool choose = tir || u2 < prob;
      s.dir = choose ? normalize(mirror) : tdir;
      const float w = tir ? 1.0f : (choose ? re / prob : (1.0f - re) / (1.0f - prob));
      s.atten = scale(albedo, w);
      break;
    }
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) shade_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const V3 o = load3(a.origin, i), d = load3(a.direction, i);
  const V3 tp = load3(a.throughput, i);
  const bool alive = a.alive[i] != 0;

  float t_sel = a.t_sel[i];
  int code = a.code[i];
  if (a.t_m != nullptr) {
    const float t_m = a.t_m[i];
    const int c_m = a.c_m[i];
    if (c_m >= 0 && (t_m < t_sel || code < 0)) {
      t_sel = t_m;
      code = c_m;
    }
  }
  const bool valid = code >= 0;

  // The three radiance terms of the plain version: the sky on a miss, the
  // emission that ends a path, the additive emission of every hit.
  const V3 zero = {0.0f, 0.0f, 0.0f};
  V3 miss_term = zero, end_term = zero, hit_term = zero;
  V3 tp_out = tp, o_out = o, d_out = d;
  bool cont = false;
  if (alive && !valid) {
    V3 sky = zero;
    if (a.flags & kFlagSky) {
      const float ts = 0.5f * (normalize(d).y + 1.0f);
      sky = {1.0f + ts * (0.5f - 1.0f), 1.0f + ts * (0.7f - 1.0f),
             1.0f + ts * (1.0f - 1.0f)};
    }
    miss_term = mul(tp, sky);
  } else if (alive) {
    float t;
    V3 outward;
    long long mat_id;
    recompute(a, i, o, d, t_sel, code, t, outward, mat_id);
    const bool front = dot(d, outward) < kFltEps;
    const V3 normal = pick(front, outward, neg(outward));
    const long long m = mat_id < 0 ? 0 : mat_id;
    const int kind = (int)a.mat_kind[m];
    const V3 albedo = load3(a.mat_albedo, (int)m);
    const V3 emission = load3(a.mat_emission, (int)m);
    const float param = a.mat_param[m];

    const long long s = a.slot[i];
    long long pix = s % a.n_div;
    if (a.pixel != nullptr) pix = a.pixel[pix];
    const long long sid = s / a.m_div;
    uint32_t w0 = (uint32_t)pix, w1 = (uint32_t)a.base0[sid];
    uint32_t w2 = (uint32_t)(a.bounce + 1), w3 = (uint32_t)a.base1[sid];
    pcg4d(w0, w1, w2, w3);
    const float u0 = to_uniform(w0), u1 = to_uniform(w1), u2 = to_uniform(w2),
                u3 = to_uniform(w3);

    const Scatter sc = scatter(d, normal, front, kind, albedo, param, u0, u1, u2,
                               (unsigned)(a.flags >> 8) & 0xffu);
    if (!sc.scattered) end_term = mul(tp, sc.emitted);
    hit_term = mul(tp, emission);
    cont = sc.scattered;
    if (cont) tp_out = mul(tp, sc.atten);
    if (a.flags & kFlagRR) {
      const float p = clamp_max(
          clamp_min(max_nan(max_nan(tp_out.x, tp_out.y), tp_out.z), 0.05f), 1.0f);
      const bool survive = u3 < p;
      if (cont && survive) tp_out = {tp_out.x / p, tp_out.y / p, tp_out.z / p};
      cont = cont && survive;
    }
    if (cont) {
      o_out = add(o, scale(d, t));
      d_out = sc.dir;
    }
  }
  V3 rad = load3(a.radiance, i);
  rad = add(rad, miss_term);
  rad = add(rad, end_term);
  rad = add(rad, hit_term);
  store3(a.radiance_out, i, rad);
  store3(a.throughput_out, i, tp_out);
  store3(a.origin_out, i, o_out);
  store3(a.direction_out, i, d_out);
  a.alive_out[i] = cont ? 1 : 0;
}

}  // namespace

extern "C" int rtnw_shade(
    const float* origin, const float* direction, const float* time,
    const float* throughput, const float* radiance, const unsigned char* alive,
    const float* t_sel, const int32_t* code, const float* t_m, const int32_t* c_m,
    const int64_t* slot, const int64_t* pixel, const int64_t* base0,
    const int64_t* base1, long long n_div, long long m_div, const float* spheres,
    int n_sph, const float* planes, int n_pla, const float* triangles, int n_tri,
    const int64_t* mat_kind, const float* mat_albedo, const float* mat_param,
    const float* mat_emission, int n, int bounce, int flags, float* origin_out,
    float* direction_out, float* throughput_out, float* radiance_out,
    unsigned char* alive_out, void* stream) {
  ShadeArgs a;
  a.origin = origin; a.direction = direction; a.time = time;
  a.throughput = throughput; a.radiance = radiance; a.alive = alive;
  a.t_sel = t_sel; a.code = code; a.t_m = t_m; a.c_m = c_m;
  a.slot = slot; a.pixel = pixel; a.base0 = base0; a.base1 = base1;
  a.n_div = n_div; a.m_div = m_div;
  a.spheres = spheres; a.planes = planes; a.triangles = triangles;
  a.n_sph = n_sph; a.n_pla = n_pla; a.n_tri = n_tri;
  a.mat_kind = mat_kind; a.mat_albedo = mat_albedo; a.mat_param = mat_param;
  a.mat_emission = mat_emission;
  a.n = n; a.bounce = bounce; a.flags = flags;
  a.origin_out = origin_out; a.direction_out = direction_out;
  a.throughput_out = throughput_out; a.radiance_out = radiance_out;
  a.alive_out = alive_out;
  const int blocks = (n + kThreads - 1) / kThreads;
  shade_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// CTAs of the shade kernel resident on one SM, and its threads a CTA.
extern "C" int rtnw_shade_occupancy(int* ctas, int* threads) {
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, shade_kernel,
                                                            kThreads, 0);
}
