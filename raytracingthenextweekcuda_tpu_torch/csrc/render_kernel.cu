// K1: the whole-render kernel of the port, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingthenextweekcuda_tpu/ops/pallas/
// bounce_kernel.py::_render_kernel (with its helpers _raygen_core,
// _trace_sample and _bounce_core), launched there by _run_render for
// render_samples. One thread renders one pixel: for each sample it
// generates the thin-lens primary ray from pcg4d and follows it through up
// to `bounces` bounces (closest hit over spheres, planes, Havel triangles,
// Havel quads and oriented boxes, in that order; the 8-kind BSDF; sky,
// additive emission and emission termination; optional Russian roulette),
// summing the radiance in registers and writing it once.
//
// A thread leaves its bounce loop as soon as its own path dies. The TPU
// kernel runs a 1024-ray block until every ray in it has died; a dead
// ray's bounce there adds nothing and keeps its state, so the two agree.
// The material kinds are a per-thread switch; for the winning kind it
// gives what the TPU kernel's branchless select chain gives, including the
// default (the Lambertian direction, `scattered = kind != EMISSION`).
//
// What bounds it on this card: FP32 ALU work (a few hundred operations per
// primitive column per bounce) and warp divergence (paths of one warp die
// at different bounces and hit different kinds). Memory traffic is
// negligible: the packed scene rows are read from shared memory and each
// pixel writes 12 bytes once. Scene rows at their true counts are copied
// into shared memory at block start when they fit in 48 KB (Cornell is
// about 10 primitives, under 1 KB); larger scenes (a brute-force mesh pack
// of ~2.2k Havel columns is ~176 KB) are read from global memory through
// the read-only cache.
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

constexpr int kThreads = 128;
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

__device__ Hit closest_hit(const Scene& s, float ox, float oy, float oz,
                           float dx, float dy, float dz, float tm, float tmin) {
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

__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ scene_g, int ns, int np, int nt, int nq,
              int nb, int n_floats, int use_smem, const float* __restrict__ frame,
              const uint32_t* __restrict__ words, int n_samples,
              const int32_t* __restrict__ pid_g, int n, int width, int height,
              int bounces, int rr_start, float tmin, int flags,
              float* __restrict__ out) {
  extern __shared__ float smem[];
  const float* base = scene_g;
  if (use_smem) {
    for (int k = threadIdx.x; k < n_floats; k += blockDim.x) smem[k] = scene_g[k];
    __syncthreads();
    base = smem;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Scene s;
  s.ns = ns; s.np = np; s.nt = nt; s.nq = nq; s.nb = nb;
  s.sph = base;
  s.pla = s.sph + kSphRows * ns;
  s.tri = s.pla + kPlaRows * np;
  s.quad = s.tri + kHavRows * nt;
  s.box = s.quad + kHavRows * nq;

  const bool sky = flags & kFlagSky;
  const bool rr = flags & kFlagRR;
  const bool add_emission = flags & kFlagEmission;
  const bool lambertian_used = (flags >> 8) & (1 << kLambertian);

  float f[21];
#pragma unroll
  for (int k = 0; k < 21; ++k) f[k] = frame[k];

  const uint32_t p = (uint32_t)pid_g[i];
  const float xs = (float)(p % (uint32_t)width);
  const float ys = (float)(p / (uint32_t)width);
  float arx = 0.0f, ary = 0.0f, arz = 0.0f;

  for (int smp = 0; smp < n_samples; ++smp) {
    const uint32_t b0 = words[2 * smp], b1 = words[2 * smp + 1];

    // ---- thin-lens primary ray (models/camera.raygen) ----
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
    float ox = f[0] + disk_x * f[12] + disk_y * f[15];
    float oy = f[1] + disk_x * f[13] + disk_y * f[16];
    float oz = f[2] + disk_x * f[14] + disk_y * f[17];
    float dx = f[3] + dxs * f[6] + dys * f[9] - ox;
    float dy = f[4] + dxs * f[7] + dys * f[10] - oy;
    float dz = f[5] + dxs * f[8] + dys * f[11] - oz;
    float nsq = dx * dx + dy * dy + dz * dz;
    float ninv = nsq > 0.0f ? 1.0f / sqrt_f(nsq) : 0.0f;
    dx = dx * ninv; dy = dy * ninv; dz = dz * ninv;
    const float tm = u4 * (f[20] - f[19]) + f[19];

    // ---- bounces ----
    float tpx = 1.0f, tpy = 1.0f, tpz = 1.0f;
    float rx = 0.0f, ry = 0.0f, rz = 0.0f;
    for (int b = 0; b < bounces; ++b) {
      uint32_t c0 = p, c1 = b0, c2 = (uint32_t)(b + 1), c3 = b1;
      pcg4d(c0, c1, c2, c3);
      const float v0 = to_uniform(c0), v1 = to_uniform(c1),
                  v2 = to_uniform(c2), v3 = to_uniform(c3);

      Hit h = closest_hit(s, ox, oy, oz, dx, dy, dz, tm, tmin);
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
            if (lambertian_used) {
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
        if (sky) {
          float t_sky = 0.5f * (uy + 1.0f);
          rx = rx + tpx * (1.0f + t_sky * (float)(0.5 - 1.0));
          ry = ry + tpy * (1.0f + t_sky * (float)(0.7 - 1.0));
          rz = rz + tpz * (1.0f + t_sky * (float)(1.0 - 1.0));
        }
        break;
      }
      if (add_emission) {
        rx = rx + tpx * h.er;
        ry = ry + tpy * h.eg;
        rz = rz + tpz * h.eb;
      }
      if (kind == kEmission) {
        rx = rx + tpx * h.ar * h.par;
        ry = ry + tpy * h.ag * h.par;
        rz = rz + tpz * h.ab * h.par;
      }
      if (!scattered) break;
      tpx = tpx * atr; tpy = tpy * atg; tpz = tpz * atb;
      if (rr && b >= rr_start) {
        float pr = fminf(fmaxf(fmaxf(fmaxf(tpx, tpy), tpz), 0.05f), 1.0f);
        if (!(v3 < pr)) break;
        float inv_p = 1.0f / pr;
        tpx = tpx * inv_p; tpy = tpy * inv_p; tpz = tpz * inv_p;
      }
      ox = ox + h.t * dx; oy = oy + h.t * dy; oz = oz + h.t * dz;
      dx = sdx; dy = sdy; dz = sdz;
    }
    arx = arx + rx; ary = ary + ry; arz = arz + rz;
  }
  out[3 * i + 0] = arx;
  out[3 * i + 1] = ary;
  out[3 * i + 2] = arz;
}

}  // namespace

extern "C" int rtnw_render_samples(const float* scene, int n_sph, int n_pla,
                                   int n_trih, int n_quad, int n_box,
                                   const float* frame, const uint32_t* words,
                                   int n_samples, const int32_t* pid, int n,
                                   int width, int height, int bounces,
                                   int rr_start, float tmin, int flags,
                                   float* out, void* stream) {
  const int n_floats = kSphRows * n_sph + kPlaRows * n_pla + kHavRows * n_trih +
                       kHavRows * n_quad + kBoxRows * n_box;
  const size_t bytes = (size_t)n_floats * sizeof(float);
  const int use_smem = bytes <= (size_t)kSmemLimit ? 1 : 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  render_kernel<<<blocks, kThreads, use_smem ? bytes : 0,
                  (cudaStream_t)stream>>>(
      scene, n_sph, n_pla, n_trih, n_quad, n_box, n_floats, use_smem, frame,
      words, n_samples, pid, n, width, height, bounces, rr_start, tmin, flags,
      out);
  return (int)cudaGetLastError();
}

extern "C" const char* rtnw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
