"""Packed-scene container, its host packer, and the analytic closest-hit
kernel K3 (counterpart of
raytracingthenextweekcuda_tpu/ops/pallas/intersect_kernel.py).

The packed rows are planar (K, pad128) float32 arrays, padded with
never-hit columns, bit-equal to the reference's.

K3 (csrc/intersect_kernel.cu) selects each ray's closest hit over the
packed spheres, planes and (optionally) Möller–Trumbore triangles and
returns (t, code), code = type << 24 | index, (BIG, -1) on a miss and for
dead rays. `intersect_packed` is its entry: tensors on a CUDA device launch
the kernel (or raise), tensors on the CPU run `closest_hit_reference`, the
same selection in vectorized torch. There is no fallback from one to the
other.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import EPSILON, FLT_EPSILON
from raytracingthenextweekcuda_tpu_torch.ops import fmath
from raytracingthenextweekcuda_tpu_torch.ops.cuda import launch

BIG = 3.0e38

TYPE_SPHERE = 1
TYPE_PLANE = 2
TYPE_TRIANGLE = 3

# Base geometry rows K3 reads per type (spheres, planes, triangles).
K3_ROWS = (10, 13, 9)

# Primitive columns the plain version tests per vectorized step.
_PRIM_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Scene primitives packed into planar padded arrays.

    Base rows: spheres (10, Sp) cx0 cy0 cz0 dcx dcy dcz t0 inv_dt r pad;
    planes (13, Pp) pos(3) n(3) lo(3) hi(3) two_sided; triangles (9, Tp)
    v0(3) e1(3) e2(3). A shaded pack (bounce_kernel.pack_scene_shaded)
    appends 8 material rows to each and carries the Havel triangle/quad and
    oriented-box rows the render kernel reads.
    """

    spheres: np.ndarray
    planes: np.ndarray
    triangles: np.ndarray
    counts: tuple            # true (S, P, T)
    used_kinds: Optional[tuple] = None
    shaded: bool = False
    trih: Optional[np.ndarray] = None    # (20, Tp'): n(3) dc e1p(3) d1 e2p(3) d2 + mat(8)
    quadh: Optional[np.ndarray] = None   # (20, Qp): same rows, uv in [0,1]^2
    boxh: Optional[np.ndarray] = None    # (23, Bp): c(3) u(3) v(3) w(3) h(3) + mat(8)
    hcounts: tuple = (0, 0, 0)           # true (T', Q, B)
    has_emission: bool = True
    # Tile-BVH packs (triangles in leaf-tile order, `trih` over all of
    # them): node bounds (6, M) f32 and meta (5, M) i32 (is_leaf, tile
    # start, skip, subtree tile range), and the leaf-only views K4 reads,
    # bounds (6, L) f32 and tile starts (1, L) i32, and the boxes of each
    # leaf's 32-column chunks, (L, 6, C) f32 (ops/bvh_tile.chunk_bounds).
    bvh_bounds: Optional[np.ndarray] = None
    bvh_meta: Optional[np.ndarray] = None
    leaf_bounds: Optional[np.ndarray] = None
    leaf_tiles: Optional[np.ndarray] = None
    chunk_bounds: Optional[np.ndarray] = None


def _pad128(n: int) -> int:
    return max(128, ((n + 127) // 128) * 128)


def pack_scene_host(scene) -> PackedScene:
    """Pack a scene's primitive arrays into planar padded rows (numpy)."""
    npf = np.float32

    sph = scene.spheres
    S = sph.count
    sp = np.zeros((10, _pad128(S)), npf)
    if S:
        c0 = np.asarray(sph.center0, npf)
        dc = np.asarray(sph.center1, npf) - c0
        t0 = np.asarray(sph.time0, npf)
        t1 = np.asarray(sph.time1, npf)
        sp[0:3, :S] = c0.T
        sp[3:6, :S] = dc.T
        sp[6, :S] = t0
        sp[7, :S] = npf(1.0) / (t1 - t0)
        sp[8, :S] = np.asarray(sph.radius, npf)
    # radius 0 in padding: the discriminant test never passes.

    pla = scene.planes
    P = pla.count
    pp = np.zeros((13, _pad128(P)), npf)
    if P:
        pos = np.asarray(pla.position, npf)
        ext = np.asarray(pla.extend, npf)
        lo = pos - ext
        hi = pos + ext
        # Only the two axes named by the orientation bound the plane:
        # XY -> z free, YZ -> x free, XZ -> y free.
        open_axis = np.asarray([2, 0, 1], np.int32)[np.asarray(pla.orientation)]
        is_open = np.arange(3)[None, :] == open_axis[:, None]
        lo = np.where(is_open, npf(-3e38), lo)
        hi = np.where(is_open, npf(3e38), hi)
        pp[0:3, :P] = pos.T
        pp[3:6, :P] = np.asarray(pla.normal, npf).T
        pp[6:9, :P] = lo.T
        pp[9:12, :P] = hi.T
        pp[12, :P] = np.asarray(pla.two_sided).astype(npf)
    # padding: normal 0, so the denominator gate fails.

    tri = scene.triangles
    T = tri.count
    tp = np.zeros((9, _pad128(T)), npf)
    if T:
        v = np.asarray(tri.vertices, npf)
        tp[0:3, :T] = v[:, 0].T
        tp[3:6, :T] = (v[:, 1] - v[:, 0]).T
        tp[6:9, :T] = (v[:, 2] - v[:, 0]).T

    kinds = np.asarray(scene.materials.kind)
    used_kinds = tuple(sorted({int(k) for k in kinds}))
    has_emission = bool(np.any(np.asarray(scene.materials.emission)))
    return PackedScene(sp, pp, tp, (S, P, T), used_kinds,
                       has_emission=has_emission)


# --------------------------------------------------------------------------
# K3: analytic closest hit
# --------------------------------------------------------------------------

class AnalyticRows(NamedTuple):
    """K3's scene on one device: the base rows of spheres (10, S), planes
    (13, P) and triangles (9, T) at their true counts, each row-major, in
    one flat float32 tensor."""

    rows: torch.Tensor
    counts: tuple  # (S, P, T)

    def split(self) -> tuple:
        """(rows, count) views per type, in K3's order."""
        out, off = [], 0
        for nrow, cnt in zip(K3_ROWS, self.counts):
            out.append(self.rows[off: off + nrow * cnt].view(nrow, cnt))
            off += nrow * cnt
        return tuple(out)


def analytic_rows(packed: PackedScene, device,
                  include_triangles: bool = True) -> AnalyticRows:
    """K3's rows of a (shaded or base) pack, on `device`."""
    S, P, T = packed.counts
    if not include_triangles:
        T = 0
    blocks = [packed.spheres[:10, :S], packed.planes[:13, :P],
              packed.triangles[:9, :T]]
    flat = np.concatenate([np.ascontiguousarray(b, np.float32).reshape(-1)
                           for b in blocks])
    return AnalyticRows(torch.from_numpy(flat).to(device), (S, P, T))


def intersect_packed(rays, scene: AnalyticRows, tmin: float = EPSILON,
                     alive=None):
    """Closest hit of `rays` (ops/rays.Rays) over the rows of `scene` (on
    the rays' device): (t (N,) float32, code (N,) int32), code = type << 24
    | index, (BIG, -1) on a miss and where `alive` (N,) bool is False.
    Triangles are back-face culled; rows built without triangles
    (`analytic_rows(..., include_triangles=False)`) cover spheres and
    planes only, as on the mesh path, where K4 covers the mesh.
    """
    dev = rays.origin.device
    n = rays.count
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    return launch.by_device(dev, _launch, closest_hit_reference, rays.origin,
                            rays.direction, rays.time, alive, scene, float(tmin))


def _launch(origin, direction, time, alive, scene: AnalyticRows, tmin):
    dev = origin.device
    n = origin.shape[0]
    n_floats = sum(r * c for r, c in zip(K3_ROWS, scene.counts))
    launch.check("K3", dev, ((origin, torch.float32, (n, 3)),
                             (direction, torch.float32, (n, 3)),
                             (time, torch.float32, (n,)),
                             (alive, torch.bool, (n,)),
                             (scene.rows, torch.float32, (n_floats,))))
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    code = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, code
    launch.call("K3", "rtnw_closest_hit", dev, scene.rows.data_ptr(), *scene.counts,
                origin.data_ptr(), direction.data_ptr(), time.data_ptr(),
                alive.data_ptr(), int(n), float(tmin), t_out.data_ptr(),
                code.data_ptr(), count=("K3",))
    return t_out, code


def _first_min(cand):
    """(min, first index of it) along dim 1."""
    idx = torch.argmin(cand, dim=1)
    return cand.gather(1, idx[:, None])[:, 0], idx


def closest_hit_reference(origin, direction, time, alive,
                          scene: AnalyticRows, tmin: float):
    """Plain K3: vectorized torch over (live rays, primitive chunks).

    The kernel walks the primitives in order with a strict `<` against the
    running best, so the first of equal minima wins; a sphere's near root
    counts when it is >= tmin, else its far root. Over chunks and types the
    same rule is a first-minimum reduction merged with a strict `<`.
    """
    n = origin.shape[0]
    dev = origin.device
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    code_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(alive).flatten()
    if live.numel() == 0:
        return t_out, code_out
    O = origin[live]
    D = direction[live]
    tm = time[live][:, None]
    ox, oy, oz = (O[:, k: k + 1] for k in range(3))
    dx, dy, dz = (D[:, k: k + 1] for k in range(3))
    a = dx * dx + dy * dy + dz * dz

    def sph_cand(r):
        w = (tm - r[6]) * r[7]
        cx, cy, cz = r[0] + r[3] * w, r[1] + r[4] * w, r[2] + r[5] * w
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r[8] * r[8]
        disc = half_b * half_b - a * c
        ok = disc > FLT_EPSILON
        sq = fmath.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
        inv_a = 1.0 / a
        r0 = (-half_b - sq) * inv_a
        r1 = (-half_b + sq) * inv_a
        t = torch.where(r0 >= tmin, r0, r1)
        return t, ok & (t >= tmin)

    def pla_cand(r):
        nx, ny, nz = r[3], r[4], r[5]
        denom = dx * nx + dy * ny + dz * nz
        two_sided = r[12] > 0.5
        gate = torch.where(two_sided, denom.abs() > EPSILON, denom > EPSILON)
        inv_den = 1.0 / torch.where(gate, denom, torch.ones_like(denom))
        t = ((r[0] - ox) * nx + (r[1] - oy) * ny + (r[2] - oz) * nz) * inv_den
        hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
        inside = ((hx > r[6]) & (hx < r[9]) & (hy > r[7]) & (hy < r[10])
                  & (hz > r[8]) & (hz < r[11]))
        return t, gate & inside & (t >= tmin)

    def tri_cand(r):
        e1x, e1y, e1z, e2x, e2y, e2z = r[3], r[4], r[5], r[6], r[7], r[8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = det > FLT_EPSILON  # back-face cull
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tx, ty, tz = ox - r[0], oy - r[1], oz - r[2]
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        return t, (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > tmin))

    best = torch.full((live.numel(),), BIG, dtype=torch.float32, device=dev)
    code = torch.full((live.numel(),), -1, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for ptype, rows, fn in zip((TYPE_SPHERE, TYPE_PLANE, TYPE_TRIANGLE),
                               scene.split(), (sph_cand, pla_cand, tri_cand)):
        count = rows.shape[1]
        for lo in range(0, count, _PRIM_CHUNK):
            hi = min(count, lo + _PRIM_CHUNK)
            t, ok = fn(rows[:, lo:hi])
            m, i = _first_min(torch.where(ok, t, inf))
            take = m < best
            best = torch.where(take, m, best)
            code = torch.where(take, ((ptype << 24) | (i + lo)).to(torch.int32),
                               code)
    t_out[live] = torch.where(code >= 0, best, torch.full_like(best, BIG))
    code_out[live] = code
    return t_out, code_out
