// K3: the analytic closest-hit kernel of the port, for Hopper (sm_90a).
//
// Replaces the TPU kernels raytracingthenextweekcuda_tpu/ops/pallas/
// intersect_kernel.py::_intersect_kernel_scalar (scenes of at most 2048
// primitives) and ::_intersect_kernel (lane-tiled), launched there by
// _run_kernel for intersect_packed. Both select the same winner, and so
// does this one: one thread per ray walks the spheres, then the planes,
// then the triangles in index order, and a candidate replaces the best
// only when strictly closer, so the lowest code wins a tie. Sphere roots
// are gated by `<= best` (near root if it is in range, else the far one),
// the discriminant by `> FLT_EPSILON`, the plane denominator by EPSILON
// (one- or two-sided) and the triangle determinant by `> FLT_EPSILON`
// (back faces culled). Output: t and code = type << 24 | index, with
// (BIG, -1) on a miss. A dead ray writes (BIG, -1) and reads nothing; the
// TPU kernel computes dead rays of live blocks, but every consumer masks
// them by `alive`.
//
// What bounds it on this card: FP32 work, about 40 operations per ray and
// primitive, and for the mesh path (two planes) the 56 bytes each ray
// reads and the 8 it writes. The packed rows at their true counts are
// copied into shared memory at block start when they fit in 48 KB;
// larger packs are read from global memory through the read-only cache.
//
// Rounding follows the plain torch version (ops/cuda/intersect_kernel.py
// closest_hit_reference): no fused multiply-add (built with --fmad=false),
// true divisions and the correctly rounded sqrtf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kFltEps = 1.1920929e-7f;
constexpr float kPlaneEps = 1e-3f;
constexpr int kThreads = 128;
constexpr int kSmemLimit = 48 * 1024;
constexpr int kSphRows = 10, kPlaRows = 13, kTriRows = 9;

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ rows_g, int ns, int np, int nt,
                   int n_floats, int use_smem, const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ time,
                   const unsigned char* __restrict__ alive, int n, float tmin,
                   float* __restrict__ t_out, int32_t* __restrict__ code_out) {
  extern __shared__ float smem[];
  const float* rows = rows_g;
  if (use_smem) {
    for (int k = threadIdx.x; k < n_floats; k += blockDim.x) smem[k] = rows_g[k];
    __syncthreads();
    rows = smem;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!alive[i]) {
    t_out[i] = kBig;
    code_out[i] = -1;
    return;
  }
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1],
              dz = direction[3 * i + 2];
  const float tm = time[i];
  const float* sph = rows;
  const float* pla = sph + kSphRows * ns;
  const float* tri = pla + kPlaRows * np;

  float best = kBig;
  int32_t code = -1;

  const float a = dx * dx + dy * dy + dz * dz;
  for (int s = 0; s < ns; ++s) {
#define S(r) sph[(r) * ns + s]
    const float w = (tm - S(6)) * S(7);
    const float cx = S(0) + S(3) * w, cy = S(1) + S(4) * w, cz = S(2) + S(5) * w;
    const float r = S(8);
#undef S
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float half_b = ocx * dx + ocy * dy + ocz * dz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
    const float disc = half_b * half_b - a * c;
    const bool ok = disc > kFltEps;
    const float sq = sqrtf(ok ? disc : 1.0f);
    const float inv_a = 1.0f / a;
    const float r0 = (-half_b - sq) * inv_a;
    const float r1 = (-half_b + sq) * inv_a;
    const bool in0 = r0 >= tmin && r0 <= best;
    const bool in1 = r1 >= tmin && r1 <= best;
    const float t = in0 ? r0 : r1;
    if (ok && (in0 || in1) && t < best) {
      best = t;
      code = (1 << 24) | s;
    }
  }
  for (int p = 0; p < np; ++p) {
#define P(r) pla[(r) * np + p]
    const float nx = P(3), ny = P(4), nz = P(5);
    const float denom = dx * nx + dy * ny + dz * nz;
    const bool gate = P(12) > 0.5f ? fabsf(denom) > kPlaneEps : denom > kPlaneEps;
    const float inv_den = 1.0f / (gate ? denom : 1.0f);
    const float t =
        ((P(0) - ox) * nx + (P(1) - oy) * ny + (P(2) - oz) * nz) * inv_den;
    const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
    const bool inside = hx > P(6) && hx < P(9) && hy > P(7) && hy < P(10) &&
                        hz > P(8) && hz < P(11);
#undef P
    if (gate && inside && t >= tmin && t < best) {
      best = t;
      code = (2 << 24) | p;
    }
  }
  for (int k = 0; k < nt; ++k) {
#define T(r) tri[(r) * nt + k]
    const float e1x = T(3), e1y = T(4), e1z = T(5);
    const float e2x = T(6), e2y = T(7), e2z = T(8);
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = det > kFltEps;
    const float inv = 1.0f / (ok ? det : 1.0f);
    const float tx = ox - T(0), ty = oy - T(1), tz = oz - T(2);
#undef T
    const float u = (tx * px + ty * py + tz * pz) * inv;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
    if (ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
        t > tmin && t < best) {
      best = t;
      code = (3 << 24) | k;
    }
  }
  t_out[i] = code >= 0 ? best : kBig;
  code_out[i] = code;
}

}  // namespace

extern "C" int rtnw_closest_hit(const float* rows, int n_sph, int n_pla,
                                int n_tri, const float* origin,
                                const float* direction, const float* time,
                                const unsigned char* alive, int n, float tmin,
                                float* t_out, int32_t* code_out, void* stream) {
  const int n_floats = kSphRows * n_sph + kPlaRows * n_pla + kTriRows * n_tri;
  const size_t bytes = (size_t)n_floats * sizeof(float);
  const int use_smem = bytes <= (size_t)kSmemLimit ? 1 : 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  closest_hit_kernel<<<blocks, kThreads, use_smem ? bytes : 0,
                       (cudaStream_t)stream>>>(
      rows, n_sph, n_pla, n_tri, n_floats, use_smem, origin, direction, time,
      alive, n, tmin, t_out, code_out);
  return (int)cudaGetLastError();
}

// CTAs of K3 resident on one SM at a launch's shared memory, and its
// threads a CTA.
extern "C" int rtnw_closest_hit_occupancy(int n_sph, int n_pla, int n_tri,
                                          int* ctas, int* threads) {
  const size_t bytes =
      (size_t)(kSphRows * n_sph + kPlaRows * n_pla + kTriRows * n_tri) * sizeof(float);
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, closest_hit_kernel, kThreads, bytes <= (size_t)kSmemLimit ? bytes : 0);
}
