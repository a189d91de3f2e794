"""The bounce kernels K1, K2 and K0, their plain torch versions, and the
host packers (counterpart of raytracingthenextweekcuda_tpu/ops/pallas/
bounce_kernel.py: 75-506 and 1303-1951).

The three kernels (csrc/render_kernel.cu) share one bounce body:
- K1, `render_samples`, renders a whole pass in one launch: for each pixel
  and each sample it generates the thin-lens primary ray from pcg4d and
  traces it through up to `bounces` bounces over the packed spheres,
  planes, Havel triangles and quads, and oriented boxes, summing the
  radiance. On a tile-BVH pack the triangles are found by a walk of the
  tile-BVH instead (the reference's consensus branch, bounce_kernel.py:
  820-1044): the kernels walk it with a warp's consensus, the plain version
  as one consensus block over the wavefront; both scan each leaf's real
  columns only and find the same winner.
- K2, `path_trace`, traces a supplied wavefront of one sample to the end.
- K0, `bounce_step`, advances the planar carry of `planar_state` by one
  bounce on pre-drawn uniforms.
Each entry dispatches by device: tensors on a CUDA device launch the kernel
(or raise), tensors on the CPU run the plain version, the same function in
vectorized torch. There is no fallback from one to the other. None of the
kernels has a backward: `guard` joins each output to the inputs so that a
backward through it raises (`ForwardOnly`) instead of giving zeros.

Both versions round alike: float32 everywhere, with sqrt, 1/sqrt, sin, cos,
exp and log taken in float64 and rounded to float32 (the kernel calls the
same CUDA double functions that torch calls on a float64 CUDA tensor). That
makes them the correctly rounded float32 functions on every device, so the
plain version on the CPU and the kernel on the card give the same image.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import EPSILON, FLT_EPSILON
from raytracingthenextweekcuda_tpu_torch.models.camera import pack_frame, raygen
from raytracingthenextweekcuda_tpu_torch.ops.fmath import (
    cos as _cos,
    div as _div,
    exp as _exp,
    log as _log,
    rsqrt as _rsqrt,
    sin as _sin,
    sqrt as _sqrt,
)
from raytracingthenextweekcuda_tpu_torch.ops.cuda.bvh_winner_kernel import real_columns
from raytracingthenextweekcuda_tpu_torch.ops.cuda.intersect_kernel import (
    BIG,
    PackedScene,
    _first_min,
    _pad128,
    pack_scene_host,
)
from raytracingthenextweekcuda_tpu_torch.ops.cuda.work import (
    WORK,
    count_leaves,
    tile_triangles,
)
from raytracingthenextweekcuda_tpu_torch.ops.geometry import (
    COAT,
    DIELECTRIC,
    EMISSION,
    LAMBERTIAN,
    METAL,
    PHONG_METAL,
    REFRACTION,
    SPECULAR,
)
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays
from raytracingthenextweekcuda_tpu_torch.ops.rng import pcg4d, to_uniform

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)

# Material-attribute rows appended to each packed primitive array:
# kind, albedo rgb, param, emission rgb.
MAT_ROWS = 8
# Geometry rows of a Havel-packed triangle/quad and of an oriented box.
HAVEL_ROWS = 12
BOX_ROWS = 15
# Base geometry rows of the shaded sphere and plane arrays.
SPH_ROWS = 10
PLA_ROWS = 13
# Rows per primitive type in the flat scene buffer K1 reads, in its order.
TYPE_ROWS = {"sph": SPH_ROWS + MAT_ROWS, "pla": PLA_ROWS + MAT_ROWS,
             "trih": HAVEL_ROWS + MAT_ROWS, "quad": HAVEL_ROWS + MAT_ROWS,
             "box": BOX_ROWS + MAT_ROWS}

# Launches of K1, K2 and K0, each counted by its wrapper where it launches
# the kernel; the *_BVH_LAUNCHES count the launches of the tile-BVH
# instantiations among them.
KERNEL_LAUNCHES = 0
PATH_LAUNCHES = 0
BOUNCE_LAUNCHES = 0
KERNEL_BVH_LAUNCHES = 0
PATH_BVH_LAUNCHES = 0
BOUNCE_BVH_LAUNCHES = 0

# Primitive columns the plain version tests per vectorized step.
_PRIM_CHUNK = 256
# Rays per step of the plain version's leaf tests (bounds its memory).
_RAY_CHUNK = 1 << 15


# --------------------------------------------------------------------------
# Host packers (numpy)
# --------------------------------------------------------------------------

def _mat_rows_np(materials, material_id):
    """(8, P) material-attribute rows for per-primitive material ids."""
    mid = np.maximum(np.asarray(material_id), 0)
    kind = np.asarray(materials.kind)[mid].astype(np.float32)
    albedo = np.asarray(materials.albedo, np.float32)[mid]
    param = np.asarray(materials.param, np.float32)[mid]
    emis = np.asarray(materials.emission, np.float32)[mid]
    return np.stack(
        [kind, albedo[:, 0], albedo[:, 1], albedo[:, 2], param,
         emis[:, 0], emis[:, 1], emis[:, 2]], axis=0,
    )


def _merge_parallelograms(verts, mat_id):
    """Coplanar triangle pairs that form parallelograms, merged into quads.

    A pair qualifies when it shares an edge, the two opposite vertices are
    reflections through the edge midpoint (within 1e-5 relative), both
    carry the same material, and their windings agree (so backface culling
    is kept). Returns (q_v0, q_e1, q_e2, q_mat, rest_idx): quad frames
    (points v0 + u*e1 + v*e2, u, v in [0, 1]) and the unmerged triangles.
    """
    T = verts.shape[0]
    edge_map: dict = {}
    for t in range(T):
        for k in range(3):
            a = verts[t, k].tobytes()
            b = verts[t, (k + 1) % 3].tobytes()
            key = (a, b) if a < b else (b, a)
            edge_map.setdefault(key, []).append((t, (k + 2) % 3))
    used = np.zeros(T, bool)
    q_v0, q_e1, q_e2, q_mat = [], [], [], []
    for lst in edge_map.values():
        if len(lst) != 2:
            continue
        (t1, o1), (t2, o2) = lst
        if t1 == t2 or used[t1] or used[t2] or mat_id[t1] != mat_id[t2]:
            continue
        p1, p2 = verts[t1, o1], verts[t2, o2]
        a = verts[t1, (o1 + 1) % 3]
        b = verts[t1, (o1 + 2) % 3]
        scale = max(float(np.abs(verts[t1]).max()), 1e-6)
        if np.abs((a + b - p1) - p2).max() > 1e-5 * scale:
            continue
        n1 = np.cross(verts[t1, 1] - verts[t1, 0], verts[t1, 2] - verts[t1, 0])
        n2 = np.cross(verts[t2, 1] - verts[t2, 0], verts[t2, 2] - verts[t2, 0])
        if np.dot(n1, n2) <= 0.0:  # inconsistent winding: culling would change
            continue
        e1, e2 = a - p1, b - p1
        if np.dot(n1, np.cross(e1, e2)) < 0.0:
            e1, e2 = e2, e1
        used[t1] = used[t2] = True
        q_v0.append(p1)
        q_e1.append(e1)
        q_e2.append(e2)
        q_mat.append(mat_id[t1])
    rest = np.nonzero(~used)[0]
    return (
        np.asarray(q_v0, np.float32).reshape(-1, 3),
        np.asarray(q_e1, np.float32).reshape(-1, 3),
        np.asarray(q_e2, np.float32).reshape(-1, 3),
        np.asarray(q_mat, np.int32).reshape(-1),
        rest,
    )


def _merge_boxes(q_v0, q_e1, q_e2, q_mat):
    """Groups of 6 parallelogram quads that close a box, merged into one
    oriented box (OBB).

    A 6-quad vertex-connected component qualifies when its corners are
    exactly the 8 points c +- hu*u +- hv*v +- hw*w of an orthogonal frame
    and every quad's outward normal points away from c (entry-face hits
    only, as the culled quad shell). Returns (box_c (B,3), box_axes
    (B,3,3) unit rows, box_h (B,3), box_mat (B,), rest_idx) with rest_idx
    indexing the surviving quads.
    """
    Q = q_v0.shape[0]
    if Q < 6:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3), np.float32), np.zeros((0,), np.int32),
                np.arange(Q))
    corners = np.stack(
        [q_v0, q_v0 + q_e1, q_v0 + q_e2, q_v0 + q_e1 + q_e2], axis=1
    )  # (Q, 4, 3)
    # Union-find over exact vertex bytes (merged quads reuse mesh vertices).
    parent = list(range(Q))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    vert_owner: dict = {}
    for q in range(Q):
        for k in range(4):
            key = corners[q, k].tobytes()
            if key in vert_owner:
                a, b = find(vert_owner[key]), find(q)
                if a != b:
                    parent[b] = a
            else:
                vert_owner[key] = q
    groups: dict = {}
    for q in range(Q):
        groups.setdefault(find(q), []).append(q)

    used = np.zeros(Q, bool)
    box_c, box_axes, box_h, box_mat = [], [], [], []
    for members in groups.values():
        if len(members) != 6:
            continue
        qs = np.asarray(members)
        if len(set(int(q_mat[q]) for q in qs)) != 1:
            continue
        pts = corners[qs].reshape(-1, 3)
        uniq = np.unique(pts.round(decimals=6), axis=0)
        if uniq.shape[0] != 8:
            continue
        c = uniq.mean(axis=0)
        # Box axes: the 3 distinct (+-) edge directions among the quads.
        edges = np.concatenate([q_e1[qs], q_e2[qs]], axis=0)  # (12, 3)
        lens = np.linalg.norm(edges, axis=1)
        if (lens < 1e-12).any():
            continue
        dirs = edges / lens[:, None]
        axes = []
        ok = True
        for d, ln in zip(dirs, lens):
            for a, _ in axes:
                if abs(np.dot(d, a)) > 1.0 - 1e-5:
                    break
            else:
                axes.append((d, ln))
        if len(axes) != 3:
            continue
        A = np.stack([a for a, _ in axes])       # (3, 3)
        H = np.asarray([ln for _, ln in axes]) * 0.5
        if np.abs(A @ A.T - np.eye(3)).max() > 1e-4:   # orthogonal frame?
            continue
        loc = (uniq - c) @ A.T                   # (8, 3) local coordinates
        scale = max(float(np.abs(uniq).max()), 1e-6)
        if np.abs(np.abs(loc) - H[None, :]).max() > 1e-4 * scale:
            ok = False
        if ok:  # outward-facing quads (culling parity)
            for q in qs:
                n = np.cross(q_e1[q], q_e2[q])
                qc = corners[q].mean(axis=0)
                if np.dot(n, qc - c) <= 0.0:
                    ok = False
                    break
        if not ok:
            continue
        used[qs] = True
        box_c.append(c)
        box_axes.append(A)
        box_h.append(H)
        box_mat.append(int(q_mat[qs[0]]))
    rest = np.nonzero(~used)[0]
    return (
        np.asarray(box_c, np.float32).reshape(-1, 3),
        np.asarray(box_axes, np.float32).reshape(-1, 3, 3),
        np.asarray(box_h, np.float32).reshape(-1, 3),
        np.asarray(box_mat, np.int32).reshape(-1),
        rest,
    )


def _pack_boxes(box_c, box_axes, box_h, box_mat, materials):
    """Box arrays -> (BOX_ROWS + MAT_ROWS, pad128) planar rows."""
    B = box_c.shape[0]
    out = np.zeros((BOX_ROWS + MAT_ROWS, _pad128(B)), np.float32)
    if B:
        out[0:3, :B] = box_c.T
        out[3:12, :B] = box_axes.reshape(B, 9).T
        out[12:15, :B] = box_h.T  # padding h = 0: degenerate, never hit
        out[BOX_ROWS:, :B] = _mat_rows_np(materials, box_mat)
    return out


def _pack_havel(v0, e1, e2, mat_id, materials):
    """(K, 3) parallelogram/triangle frames -> (20, pad128) Havel rows.

    Rows: unit normal (3), plane offset dc = n.v0, edge plane 1 (3) + d1,
    edge plane 2 (3) + d2, then the 8 material rows. The hit test is
    t = (dc - n.o)/(n.d); u = e1p.h + d1; v = e2p.h + d2.
    """
    K = v0.shape[0]
    out = np.zeros((HAVEL_ROWS + MAT_ROWS, _pad128(K)), np.float32)
    if K:
        n = np.cross(e1, e2)
        nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
        n_unit = n / np.sqrt(nn)
        e1p = np.cross(e2, n) / nn
        e2p = np.cross(n, e1) / nn
        out[0:3, :K] = n_unit.T
        out[3, :K] = (n_unit * v0).sum(-1)
        out[4:7, :K] = e1p.T
        out[7, :K] = -(e1p * v0).sum(-1)
        out[8:11, :K] = e2p.T
        out[11, :K] = -(e2p * v0).sum(-1)
        out[HAVEL_ROWS:, :K] = _mat_rows_np(materials, np.asarray(mat_id, np.int32))
    # Padding columns: n = 0, so dn = 0 and the gate fails.
    return out


def _pack_tile_bvh(scene, tile_bvh, T):
    """Node, leaf and Havel rows of a tile-BVH pack (reference
    bounce_kernel.py:417-456); the triangles are already in tile order."""
    if tile_bvh.padded_tri_count != T:
        raise ValueError(f"triangles ({T}) not in tile order "
                         f"({tile_bvh.padded_tri_count})")
    meta3 = np.asarray(tile_bvh.meta)
    leaves = meta3[0] == 1
    bounds = np.asarray(tile_bvh.bounds, np.float32)
    # Rows 3-4 of the meta: the contiguous leaf-tile range [lo, hi) of each
    # subtree (DFS preorder emits leaf tiles in increasing order).
    leaf_size = T // max(int(leaves.sum()), 1)
    before = np.concatenate([[0], np.cumsum(leaves)]).astype(np.int32)
    tile_lo = before[np.arange(meta3.shape[1])] * leaf_size
    tile_hi = before[meta3[2]] * leaf_size
    verts = np.asarray(scene.triangles.vertices, np.float32)
    v0 = verts[:, 0]
    return dict(
        bvh_bounds=bounds,
        bvh_meta=np.concatenate([meta3, tile_lo[None], tile_hi[None]],
                                axis=0).astype(np.int32),
        leaf_bounds=bounds[:, leaves],
        leaf_tiles=meta3[1][leaves][None, :].astype(np.int32),
        # Padding slots (zero vertices) pack a zero normal: never hit.
        trih=_pack_havel(v0, verts[:, 1] - v0, verts[:, 2] - v0,
                         np.asarray(scene.triangles.material_id),
                         scene.materials),
        quadh=np.zeros((HAVEL_ROWS + MAT_ROWS, 1), np.float32),
    )


def pack_scene_shaded(scene, tile_bvh=None) -> PackedScene:
    """PackedScene whose per-type arrays carry the 8 material rows.

    Without `tile_bvh`, the triangles are merged into Havel quads and
    oriented boxes where they can be and packed as Havel rows (the render
    kernel's brute-force mesh). With `tile_bvh` (ops/bvh_tile.TileBVH),
    `scene.triangles` must already be in its leaf-tile order
    (models/scene.finalize does this): every triangle is Havel-packed in
    that order and the node and leaf arrays ride along for K4.
    """
    base = pack_scene_host(scene)
    S, P, T = base.counts

    def extend(arr, prim, count):
        out = np.zeros((arr.shape[0] + MAT_ROWS, arr.shape[1]), np.float32)
        out[: arr.shape[0]] = arr
        if count:
            out[arr.shape[0]:, :count] = _mat_rows_np(scene.materials,
                                                      prim.material_id)
        return out

    trih = quadh = boxh = None
    hcounts = (0, 0, 0)
    bvh = {}
    if tile_bvh is not None:
        bvh = _pack_tile_bvh(scene, tile_bvh, T)
        trih, quadh = bvh.pop("trih"), bvh.pop("quadh")
    elif T:
        verts = np.asarray(scene.triangles.vertices, np.float32)
        mids = np.asarray(scene.triangles.material_id)
        qv0, qe1, qe2, qmat, rest = _merge_parallelograms(verts, mids)
        b_c, b_axes, b_h, b_mat, qrest = _merge_boxes(qv0, qe1, qe2, qmat)
        qv0, qe1, qe2, qmat = qv0[qrest], qe1[qrest], qe2[qrest], qmat[qrest]
        v0 = verts[rest, 0]
        trih = _pack_havel(v0, verts[rest, 1] - v0, verts[rest, 2] - v0,
                           mids[rest], scene.materials)
        quadh = _pack_havel(qv0, qe1, qe2, qmat, scene.materials)
        boxh = _pack_boxes(b_c, b_axes, b_h, b_mat, scene.materials)
        hcounts = (int(rest.shape[0]), int(qmat.shape[0]), int(b_mat.shape[0]))

    return PackedScene(
        extend(base.spheres, scene.spheres, S),
        extend(base.planes, scene.planes, P),
        extend(base.triangles, scene.triangles, T),
        base.counts,
        base.used_kinds,
        shaded=True,
        trih=trih,
        quadh=quadh,
        boxh=boxh,
        hcounts=hcounts,
        has_emission=base.has_emission,
        **bvh,
    )


# --------------------------------------------------------------------------
# Kernel inputs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, kw_only=True)
class SceneInputs:
    """The packed scene and the bounce settings, as K1, K2 and K0 read them.

    `scene` is one flat float32 buffer of the packed rows at their TRUE
    counts, type after type (spheres 18 rows, planes 21, Havel triangles
    20, Havel quads 20, boxes 23), each (rows, count) row-major; `rows`
    holds (rows, count) views of it per type for the plain versions. On a
    tile-BVH pack the buffer holds the spheres and planes only, and the
    mesh is `trih`, its Havel rows in leaf-tile order, walked through
    `bvh_bounds` and `bvh_meta` (is_leaf, tile start, skip, tile_lo,
    tile_hi per node); a leaf covers `leaf_tile` columns, of which its
    first `bvh_count` are real (the rest zero padding, never hit).
    `trih_aos` holds the 12 geometry rows of `trih` column by column, the
    16-byte vectors the kernels' leaf scans read.
    """

    scene: torch.Tensor        # (F,) float32
    counts: tuple              # (n_sph, n_pla, n_trih, n_quad, n_box)
    bounces: int
    rr_start: int
    tmin: float
    sky: bool
    russian_roulette: bool
    additive_emission: bool
    used_kinds: tuple
    bvh_bounds: torch.Tensor | None = None   # (6, M) float32
    bvh_meta: torch.Tensor | None = None     # (5, M) int32
    trih: torch.Tensor | None = None         # (20, C) float32
    leaf_tile: int = 0
    bvh_count: torch.Tensor | None = None    # (M,) int32, 0 but at leaves
    trih_aos: torch.Tensor | None = None     # (C, 12) float32

    @property
    def rows(self) -> dict:
        out, off = {}, 0
        for (name, nrow), cnt in zip(TYPE_ROWS.items(), self.counts):
            out[name] = self.scene[off: off + nrow * cnt].view(nrow, cnt)
            off += nrow * cnt
        if self.trih is not None:
            out["mesh"] = self.trih
        return out

    @property
    def flags(self) -> int:
        """Bit 0 sky, 1 Russian roulette, 2 additive emission; bits 8-15
        the used material kinds."""
        mask = 0
        for k in self.used_kinds:
            mask |= 1 << int(k)
        return (int(self.sky) | int(self.russian_roulette) << 1
                | int(self.additive_emission) << 2 | mask << 8)

    def scene_fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(SceneInputs)}


@dataclasses.dataclass(frozen=True)
class RenderInputs(SceneInputs):
    """Everything one render pass of K1 reads, as tensors on one device."""

    frame: torch.Tensor        # (21,) float32
    words: torch.Tensor        # (S, 2) int32: uint32 key words per sample
    pid: torch.Tensor          # (N,) int32 pixel ids
    width: int
    height: int


@dataclasses.dataclass(frozen=True)
class PathInputs(SceneInputs):
    """What K2 reads: a wavefront of N rays of one sample."""

    origin: torch.Tensor       # (N, 3) float32
    direction: torch.Tensor    # (N, 3) float32
    time: torch.Tensor         # (N,) float32
    pid: torch.Tensor          # (N,) int32 pixel ids
    words: tuple               # (b0, b1): the sample's uint32 key words


@dataclasses.dataclass(frozen=True)
class BounceInputs(SceneInputs):
    """What K0 reads: the planar carry of N rays and one bounce's draws.
    The carry is 13 separate rows, so a trace of `bounce_step` calls hands
    each call's output rows to the next without a copy."""

    carry: tuple               # 13 x (N,) float32: ox oy oz dx dy dz tm tp rgb rad rgb
    alive: torch.Tensor        # (N,) int32
    u4: torch.Tensor           # (N, 4) float32, 16-byte aligned
    do_rr: bool


def node_columns(trih: torch.Tensor, meta: torch.Tensor,
                 leaf_tile: int) -> torch.Tensor:
    """(M,) int32: the real columns of each leaf node's tile (`real_columns`
    over the Havel normal rows of `trih`, tiles starting at meta row 1),
    0 for the interior nodes."""
    leaf = meta[0] == 1
    count = torch.zeros(meta.shape[1], dtype=torch.int32, device=meta.device)
    if bool(leaf.any()):
        count[leaf] = real_columns(trih[0:3], meta[1][leaf], leaf_tile)
    return count


def tile_bvh_fields(bounds, meta, trih, leaf_tile: int, device) -> dict:
    """The tile-BVH fields of SceneInputs on `device`, from the host arrays
    of node bounds (6, M), node meta (5, M) and Havel rows (20, C): with
    each node's real columns and the geometry rows column by column."""
    def on(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    meta, trih = on(meta, np.int32), on(trih, np.float32)
    return dict(bvh_bounds=on(bounds, np.float32), bvh_meta=meta, trih=trih,
                leaf_tile=int(leaf_tile),
                bvh_count=node_columns(trih, meta, leaf_tile),
                trih_aos=trih[:HAVEL_ROWS].t().contiguous())


def _tile_bvh_inputs(packed: PackedScene, device) -> dict:
    """The tile-BVH fields of SceneInputs, on `device`; the leaf width is
    the reference's `trih.shape[1] // leaf_tiles.shape[1]`."""
    return tile_bvh_fields(packed.bvh_bounds, packed.bvh_meta, packed.trih,
                           packed.trih.shape[1] // packed.leaf_tiles.shape[1],
                           device)


def device_or_raise(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but CUDA is not available")
    return device


def scene_inputs(packed: PackedScene, cfg, device="cuda") -> SceneInputs:
    """The packed scene's rows and `cfg`'s bounce settings on `device`."""
    device = device_or_raise(device)
    if not packed.shaded:
        raise ValueError("the bounce kernels need a shaded pack (models.scene.finalize)")
    S, P, T = packed.counts
    nt, nq, nb = packed.hcounts
    tile_bvh = packed.leaf_bounds is not None
    if T and not tile_bvh and not (nt or nq or nb):
        raise ValueError("triangles must be Havel-packed (pack_scene_shaded)")
    blocks = [packed.spheres[:, :S], packed.planes[:, :P]]
    if packed.trih is not None and not tile_bvh:
        blocks += [packed.trih[:, :nt], packed.quadh[:, :nq], packed.boxh[:, :nb]]
    else:
        nt = nq = nb = 0
    flat = np.concatenate([np.ascontiguousarray(b, np.float32).reshape(-1)
                           for b in blocks])
    used = packed.used_kinds if packed.used_kinds is not None else tuple(range(8))
    return SceneInputs(
        scene=torch.from_numpy(flat).to(device),
        counts=(S, P, nt, nq, nb),
        bounces=int(cfg.bounces), rr_start=int(cfg.rr_start_bounce),
        tmin=float(cfg.tmin), sky=bool(cfg.sky_background),
        russian_roulette=bool(cfg.russian_roulette),
        additive_emission=bool(packed.has_emission),
        used_kinds=tuple(int(k) for k in used),
        **(_tile_bvh_inputs(packed, device) if tile_bvh else {}),
    )


def render_inputs(packed: PackedScene, frame, sample_words, cfg,
                  pixel_ids=None, device="cuda") -> RenderInputs:
    """Build K1's inputs on `device` from host data."""
    sc = scene_inputs(packed, cfg, device)
    words = np.asarray(sample_words, np.uint32).reshape(-1, 2)
    if pixel_ids is None:
        pid = torch.arange(cfg.num_pixels, dtype=torch.int32)
    else:
        pid = torch.as_tensor(pixel_ids).to(torch.int32)
    return RenderInputs(
        **sc.scene_fields(),
        frame=pack_frame(frame, device),
        words=torch.from_numpy(words.view(np.int32).copy()).to(device),
        pid=pid.to(device),
        width=int(cfg.width), height=int(cfg.height),
    )


def path_inputs(packed: PackedScene, rays: Rays, ctx, cfg) -> PathInputs:
    """K2's inputs on the rays' device. `ctx` is the wavefront's RayCtx
    (models.camera.generate_rays), whose key words must be scalars: one
    sample per wavefront."""
    if any(torch.is_tensor(w) and w.dim() for w in (ctx.base0, ctx.base1)):
        raise ValueError(
            "path_trace needs scalar RayCtx key words (one sample per "
            "wavefront); multi-sample (N,) contexts go through the sorted "
            "wavefront (models.integrator._trace_sorted)")
    dev = rays.origin.device
    sc = scene_inputs(packed, cfg, dev)
    return PathInputs(
        **sc.scene_fields(),
        origin=rays.origin.detach().float().contiguous(),
        direction=rays.direction.detach().float().contiguous(),
        time=rays.time.detach().float().contiguous(),
        pid=torch.as_tensor(ctx.pixel_id, device=dev).to(torch.int32).contiguous(),
        words=(int(ctx.base0) & 0xFFFFFFFF, int(ctx.base1) & 0xFFFFFFFF),
    )


def bounce_inputs(packed: PackedScene, state, u4, do_rr, cfg) -> BounceInputs:
    """K0's inputs on the state's device; `state` is the 14-tuple of
    `planar_state`."""
    dev = state[0].device
    sc = scene_inputs(packed, cfg, dev)
    u4 = u4.detach().float().contiguous()
    if u4.data_ptr() % 16:  # a view into another buffer: K0 reads float4
        u4 = u4.clone()
    return BounceInputs(
        **sc.scene_fields(),
        carry=tuple(state[k].detach().float().contiguous()
                    for k in range(14) if k != 7),
        alive=state[7].detach().to(torch.int32).contiguous(),
        u4=u4,
        do_rr=bool(do_rr),
    )


# --------------------------------------------------------------------------
# The guard of the forward-only kernels
# --------------------------------------------------------------------------

FORWARD_ONLY_MESSAGE = (
    "cfg.fused_bounce=True renders with the forward-only bounce kernels "
    "(K1, K2, K0); set fused_bounce=False for differentiable rendering "
    "(the torch wavefront)."
)


class ForwardOnly(torch.autograd.Function):
    """Identity that fails loudly under backward.

    The kernels have no backward, and their outputs would carry no graph:
    differentiating a fused render would silently give zero gradients.
    `guard` joins a kernel's output to its inputs through this function,
    so a backward through it raises instead."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(FORWARD_ONLY_MESSAGE)


def grad_probe(*tensors):
    """Exactly 0 in the forward, carrying every tensor of `tensors` that
    requires grad through `ForwardOnly` (0.0 when none does)."""
    live = [t for t in tensors if torch.is_tensor(t) and t.requires_grad]
    if not live:
        return 0.0
    probe = ForwardOnly.apply(sum(t.sum() for t in live))
    return probe - probe.detach()


def guard(out: torch.Tensor, *inputs) -> torch.Tensor:
    """A kernel's output joined to its inputs by `grad_probe`."""
    probe = grad_probe(*inputs)
    return out if isinstance(probe, float) else out + probe


# --------------------------------------------------------------------------
# Entries and dispatch
# --------------------------------------------------------------------------

def render_samples(packed: PackedScene, frame, sample_words, cfg,
                   pixel_ids=None, device="cuda") -> torch.Tensor:
    """Render `len(sample_words)` spp of the given pixels in one pass.

    `frame` is a camera.CameraFrame, `sample_words` the (S, 2) uint32 key
    words of the pass's samples (ops/threefry.split). Returns the summed
    radiance (N, 3) float32 on `device`: K1 on a CUDA device, the plain
    version on the CPU.
    """
    inp = render_inputs(packed, frame, sample_words, cfg, pixel_ids, device)
    return guard(render_kernel(inp), *(getattr(frame, f.name)
                                        for f in dataclasses.fields(frame)))


def render_samples_reference(packed: PackedScene, frame, sample_words, cfg,
                             pixel_ids=None, device="cpu") -> torch.Tensor:
    """The plain torch version of `render_samples`, on any device."""
    inp = render_inputs(packed, frame, sample_words, cfg, pixel_ids, device)
    return render_reference(inp)


def path_trace(packed: PackedScene, rays: Rays, ctx, cfg) -> torch.Tensor:
    """Trace one sample's wavefront to the end: radiance (N, 3) float32.

    Each bounce draws its uniforms from pcg4d(pixel, b0, bounce + 1, b1),
    the stream of the torch wavefront (models.integrator.trace). K2 on a
    CUDA device, the plain version on the CPU.
    """
    inp = path_inputs(packed, rays, ctx, cfg)
    return guard(path_kernel(inp), rays.origin, rays.direction, rays.time)


def path_trace_reference(packed: PackedScene, rays: Rays, ctx, cfg) -> torch.Tensor:
    """The plain torch version of `path_trace`, on any device."""
    return path_reference(path_inputs(packed, rays, ctx, cfg))


def planar_state(rays: Rays) -> tuple:
    """A wavefront as the planar carry of `bounce_step`: (ox, oy, oz, dx,
    dy, dz, tm, alive, tpx, tpy, tpz, rx, ry, rz), each (N,); alive int32
    ones, throughput ones, radiance zeros."""
    n = rays.count
    dev = rays.origin.device
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    return (rays.origin[:, 0], rays.origin[:, 1], rays.origin[:, 2],
            rays.direction[:, 0], rays.direction[:, 1], rays.direction[:, 2],
            rays.time, torch.ones((n,), dtype=torch.int32, device=dev),
            ones, ones, ones, zeros, zeros, zeros)


def _carry(inp: BounceInputs, rows: tuple, alive: torch.Tensor) -> tuple:
    """K0's 12 output rows and alive row back to the 14-tuple; the time
    row is the input's."""
    return (*rows[0:6], inp.carry[6], alive, *rows[6:12])


def bounce_step(packed: PackedScene, state, u4, do_rr, cfg) -> tuple:
    """One bounce over the planar carry of `planar_state`. `u4` is the
    (N, 4) uniform block of the bounce and `do_rr` whether Russian roulette
    runs on it. Dead rays pass through unchanged with alive 0. K0 on a
    CUDA device, the plain version on the CPU."""
    inp = bounce_inputs(packed, state, u4, do_rr, cfg)
    rows, alive = bounce_kernel(inp)
    probe = grad_probe(*state, u4)  # once a call: the trace is host-bound
    if not isinstance(probe, float):
        rows = tuple(r + probe for r in rows)
    return _carry(inp, rows, alive)


def bounce_step_reference(packed: PackedScene, state, u4, do_rr, cfg) -> tuple:
    """The plain torch version of `bounce_step`, on any device."""
    inp = bounce_inputs(packed, state, u4, do_rr, cfg)
    return _carry(inp, *bounce_reference(inp))


def _dispatch(dev: torch.device, launch, plain, inp):
    """CUDA tensors launch the kernel, CPU tensors run the plain version."""
    if dev.type == "cuda":
        return launch(inp)
    if dev.type == "cpu":
        return plain(inp)
    raise ValueError(f"unsupported device {dev}")


def render_kernel(inp: RenderInputs) -> torch.Tensor:
    """K1 or its plain version, by the inputs' device."""
    return _dispatch(inp.pid.device, _launch, render_reference, inp)


def path_kernel(inp: PathInputs) -> torch.Tensor:
    """K2 or its plain version, by the inputs' device."""
    return _dispatch(inp.pid.device, _launch_path, path_reference, inp)


def bounce_kernel(inp: BounceInputs) -> tuple:
    """K0 or its plain version, by the inputs' device: (the 12 (N,) float32
    rows of the carry without the time row, (N,) int32 alive)."""
    return _dispatch(inp.alive.device, _launch_bounce, bounce_reference, inp)


def _check(kernel: str, dev, specs) -> None:
    for t, dtype, shape in specs:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{kernel} input {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: expected contiguous {shape} {dtype} "
                             f"on {dev}")


def _scene_specs(inp: SceneInputs) -> tuple:
    """The (tensor, dtype, shape) checks of the scene inputs: the flat rows
    and, on a tile-BVH pack, the node and leaf-tile arrays (the column
    vectors aligned to 16 bytes, each leaf's real columns within its tile)."""
    n_floats = sum(r * c for r, c in zip(TYPE_ROWS.values(), inp.counts))
    specs = ((inp.scene, torch.float32, (n_floats,)),)
    if inp.trih is not None:
        m = inp.bvh_bounds.shape[1]
        cols = inp.trih.shape[1]
        if inp.leaf_tile <= 0 or cols % inp.leaf_tile:
            raise ValueError(f"leaf tile {inp.leaf_tile} does not divide the "
                             f"{cols} Havel columns")
        specs += ((inp.bvh_bounds, torch.float32, (6, m)),
                  (inp.bvh_meta, torch.int32, (5, m)),
                  (inp.bvh_count, torch.int32, (m,)),
                  (inp.trih, torch.float32, (HAVEL_ROWS + MAT_ROWS, cols)),
                  (inp.trih_aos, torch.float32, (cols, HAVEL_ROWS)))
        if inp.trih_aos.data_ptr() % 16:
            raise ValueError("tile-BVH input trih_aos: not aligned to 16 bytes")
        if not bool(((inp.bvh_count >= 0) & (inp.bvh_count <= inp.leaf_tile)).all()):
            raise ValueError(f"tile-BVH input bvh_count: a leaf's real columns "
                             f"outside its tile of {inp.leaf_tile}")
    return specs


def _mesh_args(inp: SceneInputs) -> tuple:
    """The tile-BVH arguments of the C entries: node bounds, node meta,
    nodes' real columns, Havel rows and their column vectors, node count
    and Havel column count (null pointers and zeros without a tile-BVH)."""
    if inp.trih is None:
        return (None, None, None, None, None, 0, 0)
    return (inp.bvh_bounds.data_ptr(), inp.bvh_meta.data_ptr(),
            inp.bvh_count.data_ptr(), inp.trih.data_ptr(),
            inp.trih_aos.data_ptr(), int(inp.bvh_bounds.shape[1]),
            int(inp.trih.shape[1]))


def _raise_on(kernel: str, lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {lib.rtnw_error_string(err).decode()} ({err})")


def _launch(inp: RenderInputs) -> torch.Tensor:
    global KERNEL_LAUNCHES, KERNEL_BVH_LAUNCHES
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    dev = inp.pid.device
    _check("K1", dev, (*_scene_specs(inp),
                       (inp.frame, torch.float32, (21,)),
                       (inp.words, torch.int32, (inp.words.shape[0], 2)),
                       (inp.pid, torch.int32, (inp.pid.shape[0],))))
    lib = build.load()
    n = inp.pid.shape[0]
    # The kernel runs on the current stream; the caching allocator reuses
    # the inputs' memory only for work queued after it on that stream.
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtnw_render_samples(
            inp.scene.data_ptr(), *inp.counts, *_mesh_args(inp),
            inp.frame.data_ptr(),
            inp.words.data_ptr(), int(inp.words.shape[0]),
            inp.pid.data_ptr(), int(n),
            inp.width, inp.height, inp.bounces, inp.rr_start,
            float(inp.tmin), inp.flags,
            out.data_ptr(), stream,
        )
    _raise_on("K1", lib, err)
    KERNEL_LAUNCHES += 1
    KERNEL_BVH_LAUNCHES += inp.trih is not None
    return out


def _launch_path(inp: PathInputs) -> torch.Tensor:
    global PATH_LAUNCHES, PATH_BVH_LAUNCHES
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    dev = inp.pid.device
    n = inp.pid.shape[0]
    _check("K2", dev, (*_scene_specs(inp),
                       (inp.origin, torch.float32, (n, 3)),
                       (inp.direction, torch.float32, (n, 3)),
                       (inp.time, torch.float32, (n,)),
                       (inp.pid, torch.int32, (n,))))
    lib = build.load()
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtnw_path_trace(
            inp.scene.data_ptr(), *inp.counts, *_mesh_args(inp),
            inp.origin.data_ptr(), inp.direction.data_ptr(),
            inp.time.data_ptr(), inp.pid.data_ptr(), *inp.words, int(n),
            inp.bounces, inp.rr_start, float(inp.tmin), inp.flags,
            out.data_ptr(), stream,
        )
    _raise_on("K2", lib, err)
    PATH_LAUNCHES += 1
    PATH_BVH_LAUNCHES += inp.trih is not None
    return out


def _launch_bounce(inp: BounceInputs) -> tuple:
    global BOUNCE_LAUNCHES, BOUNCE_BVH_LAUNCHES
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    dev = inp.alive.device
    n = inp.alive.shape[0]
    if len(inp.carry) != 13:
        raise ValueError(f"K0 input carry: {len(inp.carry)} rows, expected 13")
    _check("K0", dev, (*_scene_specs(inp),
                       *((row, torch.float32, (n,)) for row in inp.carry),
                       (inp.alive, torch.int32, (n,)),
                       (inp.u4, torch.float32, (n, 4))))
    if inp.u4.data_ptr() % 16:
        raise ValueError("K0 input u4: not aligned to 16 bytes")
    lib = build.load()
    # One allocation for the 12 output rows, handed out as row views.
    out = torch.empty((12, n), dtype=torch.float32, device=dev)
    alive = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return tuple(out.unbind(0)), alive
    rows_in = (ctypes.c_void_p * 13)(*(row.data_ptr() for row in inp.carry))
    base = out.data_ptr()
    rows_out = (ctypes.c_void_p * 12)(*(base + 4 * n * k for k in range(12)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtnw_bounce_step(
            inp.scene.data_ptr(), *inp.counts, *_mesh_args(inp),
            rows_in, rows_out, inp.alive.data_ptr(), inp.u4.data_ptr(),
            int(n), int(inp.do_rr), float(inp.tmin), inp.flags,
            alive.data_ptr(), stream,
        )
    _raise_on("K0", lib, err)
    BOUNCE_LAUNCHES += 1
    BOUNCE_BVH_LAUNCHES += inp.trih is not None
    return tuple(out.unbind(0)), alive


# --------------------------------------------------------------------------
# Plain version (vectorized torch over rays)
# --------------------------------------------------------------------------

def _where(c, a, b):
    """jnp.where with Python-scalar branches, in float32."""
    if not torch.is_tensor(a):
        a = torch.full_like(b if torch.is_tensor(b) else c, a, dtype=torch.float32)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b, dtype=torch.float32)
    return torch.where(c, a, b)


def _last_min(cand):
    """(min, last index of it) along dim 1."""
    c = cand.shape[1]
    idx = (c - 1) - torch.argmin(cand.flip(1), dim=1)
    return cand.gather(1, idx[:, None])[:, 0], idx


def _closest(rows, count, cand_fn, last: bool, best_t):
    """Closest hit of one primitive type, in the kernel's sequential order:
    (t, index, win) with `win` where it beats `best_t` (strict for all
    types but spheres, whose bound is inclusive)."""
    inf = torch.tensor(float("inf"), device=best_t.device)
    t_type = torch.full_like(best_t, float("inf"))
    i_type = torch.zeros(best_t.shape, dtype=torch.int64, device=best_t.device)
    for lo in range(0, count, _PRIM_CHUNK):
        hi = min(count, lo + _PRIM_CHUNK)
        t, ok = cand_fn(rows[:, lo:hi])
        cand = torch.where(ok, t, inf)
        m, i = (_last_min if last else _first_min)(cand)
        take = (m <= t_type) if last else (m < t_type)
        t_type = torch.where(take, m, t_type)
        i_type = torch.where(take, i + lo, i_type)
    win = (t_type <= best_t) if last else (t_type < best_t)
    return t_type, i_type, win


def _slab(bounds, node, O, inv):
    """(tn, tf) of every ray against the box of `node`."""
    tn = tf = None
    for k in range(3):
        t0 = (bounds[k, node] - O[k]) * inv[k]
        t1 = (bounds[k + 3, node] - O[k]) * inv[k]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def _tile_bvh_closest(inp: SceneInputs, O, D, best_t):
    """Closest mesh hit of every ray through the tile-BVH, in front of
    `best_t`: (t, Havel column), column -1 where the mesh does not win.

    The reference's consensus walk (bounce_kernel.py:820-968) with the
    wavefront as one block: the nodes in DFS order, a node's subtree
    entered when any ray hits its box (slab test on directions clamped to
    +-1e-20, `tf >= tn`, `tf >= tmin`, `tn < best_t`), else skipped. A leaf
    tests its real columns (`bvh_count`, a prefix of its tile; the padding
    behind them can never be hit), 128 at a time, for the rays that hit it:
    a ray takes the strictly closest triangle in front of its best, the
    lowest column among equal ones. A child's box lies inside its parent's
    and the slab arithmetic rounds monotonically, so a ray meets the leaves
    a per-ray walk meets, in the same order, with the same best: the
    kernels walk with a warp's consensus and find the same winner.
    """
    O, D = [o[:, 0] for o in O], [d[:, 0] for d in D]
    inv = [1.0 / torch.where(d.abs() < 1e-20, _where(d >= 0.0, 1e-20, -1e-20), d)
           for d in D]
    bounds, trih, tmin = inp.bvh_bounds, inp.trih, inp.tmin
    is_leaf, tile0, skip = inp.bvh_meta[0:3].cpu().tolist()
    real = inp.bvh_count.cpu().tolist()
    best_t = best_t.clone()
    col = torch.full(best_t.shape, -1, dtype=torch.int64, device=best_t.device)
    # A per-ray walk tests the root, then both children of every interior
    # node a ray hits.
    WORK["box_tests"] += best_t.numel()
    node = 0
    while node < len(is_leaf):
        tn, tf = _slab(bounds, node, O, inv)
        node_hit = (tf >= tn) & (tf >= tmin) & (tn < best_t)
        idx = torch.nonzero(node_hit).flatten()
        if idx.numel() and not is_leaf[node]:
            WORK["box_tests"] += 2 * idx.numel()
            node += 1
            continue
        if idx.numel():
            count_leaves(idx.new_tensor([idx.numel()]), tile_triangles(
                trih[0:3], idx.new_tensor([tile0[node]]), inp.leaf_tile))
            for lo in range(0, idx.numel(), _RAY_CHUNK):
                r = idx[lo: lo + _RAY_CHUNK]
                o, d = [x[r, None] for x in O], [x[r, None] for x in D]
                bt, c = best_t[r], col[r]
                end = tile0[node] + real[node]
                for first in range(tile0[node], end, 128):
                    h = trih[:, first: min(first + 128, end)]
                    dn = d[0] * h[0] + d[1] * h[1] + d[2] * h[2]
                    ok = dn < -FLT_EPSILON
                    inv_dn = 1.0 / _where(ok, dn, 1.0)
                    t = (h[3] - (o[0] * h[0] + o[1] * h[1] + o[2] * h[2])) * inv_dn
                    hx, hy, hz = o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]
                    uu = h[4] * hx + h[5] * hy + h[6] * hz + h[7]
                    vv = h[8] * hx + h[9] * hy + h[10] * hz + h[11]
                    hit = (ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                           & (t > tmin) & (t < bt[:, None]))
                    m, lane = _first_min(_where(hit, t, BIG))
                    better = m < bt
                    bt = torch.where(better, m, bt)
                    c = torch.where(better, lane + first, c)
                best_t[r], col[r] = bt, c
        node = skip[node]
    return best_t, col


def _bounce(ray, tp, rad, u, do_rr, inp: RenderInputs, rows):
    """One bounce on live rays (bounce_kernel._bounce_core parity).

    Returns the advanced (ray, tp, rad) and the continue mask."""
    ox, oy, oz, dx, dy, dz, tm = ray
    tpx, tpy, tpz = tp
    rx, ry, rz = rad
    u0, u1, u2, u3 = u
    tmin = inp.tmin
    used = set(inp.used_kinds)
    n_sph, n_pla, n_trih, n_quad, n_box = inp.counts
    eps, flt_eps = EPSILON, FLT_EPSILON

    def col(a):
        return a[:, None]

    O = [col(ox), col(oy), col(oz)]
    D = [col(dx), col(dy), col(dz)]
    a = dx * dx + dy * dy + dz * dz

    # -- per-type candidate distances over (rays, primitive chunk) ---------
    def sph_cand(r):
        w = (col(tm) - r[6]) * r[7]
        cx, cy, cz = r[0] + r[3] * w, r[1] + r[4] * w, r[2] + r[5] * w
        rad_ = r[8]
        ocx, ocy, ocz = O[0] - cx, O[1] - cy, O[2] - cz
        half_b = ocx * D[0] + ocy * D[1] + ocz * D[2]
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad_ * rad_
        disc = half_b * half_b - col(a) * c
        ok = disc > flt_eps
        sq = _sqrt(_where(ok, disc, 1.0))
        inv_a = 1.0 / col(a)
        r0 = (-half_b - sq) * inv_a
        r1 = (-half_b + sq) * inv_a
        t = torch.where(r0 >= tmin, r0, r1)
        return t, ok & (t >= tmin)

    def pla_cand(r):
        nx, ny, nz = r[3], r[4], r[5]
        denom = D[0] * nx + D[1] * ny + D[2] * nz
        two_sided = r[12] > 0.5
        gate = (denom.abs() > eps) & two_sided | ((denom > eps) & ~two_sided)
        inv_den = 1.0 / _where(gate, denom, 1.0)
        t = ((r[0] - O[0]) * nx + (r[1] - O[1]) * ny + (r[2] - O[2]) * nz) * inv_den
        hx, hy, hz = O[0] + t * D[0], O[1] + t * D[1], O[2] + t * D[2]
        inside = ((hx > r[6]) & (hx < r[9]) & (hy > r[7]) & (hy < r[10])
                  & (hz > r[8]) & (hz < r[11]))
        return t, gate & inside & (t >= tmin)

    def havel_cand(quad):
        def cand(r):
            nx, ny, nz = r[0], r[1], r[2]
            dn = D[0] * nx + D[1] * ny + D[2] * nz
            ok = dn < -flt_eps  # backface culling, as render_samples passes
            inv = 1.0 / _where(ok, dn, 1.0)
            t = (r[3] - (O[0] * nx + O[1] * ny + O[2] * nz)) * inv
            hx, hy, hz = O[0] + t * D[0], O[1] + t * D[1], O[2] + t * D[2]
            uu = r[4] * hx + r[5] * hy + r[6] * hz + r[7]
            vv = r[8] * hx + r[9] * hy + r[10] * hz + r[11]
            if quad:
                uv_ok = (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (vv <= 1.0)
            else:
                uv_ok = (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            return t, ok & uv_ok & (t > tmin)
        return cand

    def box_slab(r, Ox, Oy, Oz, Dx, Dy, Dz):
        """Oriented-box slab test: (tn, tf, entry normal)."""
        eps_b = 1e-20
        relx, rely, relz = Ox - r[0], Oy - r[1], Oz - r[2]
        shape = torch.broadcast_shapes(relx.shape, Dx.shape)
        tn = torch.full(shape, -BIG, device=relx.device)
        tf = torch.full(shape, BIG, device=relx.device)
        nxw = torch.zeros(shape, device=relx.device)
        nyw, nzw = torch.zeros_like(nxw), torch.zeros_like(nxw)
        for axis in range(3):
            axx, axy, axz = r[3 + 3 * axis], r[4 + 3 * axis], r[5 + 3 * axis]
            h = r[12 + axis]
            ol = relx * axx + rely * axy + relz * axz
            dl = Dx * axx + Dy * axy + Dz * axz
            dls = torch.where(dl.abs() < eps_b,
                              _where(dl >= 0.0, eps_b, -eps_b), dl)
            inv = 1.0 / dls
            t0 = (-h - ol) * inv
            t1 = (h - ol) * inv
            tna = torch.minimum(t0, t1)
            tfa = torch.maximum(t0, t1)
            upd = tna > tn
            s = _where(dl >= 0.0, -1.0, 1.0)
            nxw = torch.where(upd, s * axx, nxw)
            nyw = torch.where(upd, s * axy, nyw)
            nzw = torch.where(upd, s * axz, nzw)
            tn = torch.maximum(tn, tna)
            tf = torch.minimum(tf, tfa)
        return tn, tf, (nxw, nyw, nzw)

    def box_cand(r):
        tn, tf, _ = box_slab(r, *O, *D)
        return tn, (tf >= tn) & (tn >= tmin)

    # -- closest hit, type after type (spheres, planes, tris, quads, boxes) -
    best_t = torch.full_like(ox, BIG)
    winners = []  # (name, index, win mask) in primitive order
    for name, count, fn, last in (
        ("sph", n_sph, sph_cand, True), ("pla", n_pla, pla_cand, False),
        ("trih", n_trih, havel_cand(False), False),
        ("quad", n_quad, havel_cand(True), False),
        ("box", n_box, box_cand, False),
    ):
        if not count:
            continue
        t_type, i_type, win = _closest(rows[name], count, fn, last, best_t)
        best_t = torch.where(win, t_type, best_t)
        winners.append((name, i_type, win))
    if inp.trih is not None:  # the mesh, through the tile-BVH
        t_mesh, col = _tile_bvh_closest(inp, O, D, best_t)
        win = col >= 0
        best_t = torch.where(win, t_mesh, best_t)
        winners.append(("mesh", col.clamp_min(0), win))

    # -- winner attributes --------------------------------------------------
    zero = torch.zeros_like(ox)
    w_kind = torch.full_like(ox, -1.0)
    w_n = [zero, zero, zero]
    w_mat = [zero] * 7  # albedo rgb, param, emission rgb
    final = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)  # 0 = none
    for k, (name, i_type, win) in enumerate(winners):
        final = torch.where(win, torch.full_like(final, k + 1), final)
    for k, (name, i_type, _) in enumerate(winners):
        sel = final == k + 1
        r = rows[name][:, i_type]  # (rows, R) gathered per ray
        mb = {"sph": SPH_ROWS, "pla": PLA_ROWS, "box": BOX_ROWS}.get(name, HAVEL_ROWS)
        if name == "sph":
            w = (tm - r[6]) * r[7]
            cx, cy, cz = r[0] + r[3] * w, r[1] + r[4] * w, r[2] + r[5] * w
            inv_r = 1.0 / _where(r[8] != 0.0, r[8], 1.0)
            n = ((ox + best_t * dx - cx) * inv_r, (oy + best_t * dy - cy) * inv_r,
                 (oz + best_t * dz - cz) * inv_r)
        elif name == "pla":
            n = (r[3], r[4], r[5])
        elif name == "box":
            n = box_slab(r, ox, oy, oz, dx, dy, dz)[2]
        else:
            n = (r[0], r[1], r[2])
        w_kind = torch.where(sel, r[mb], w_kind)
        w_n = [torch.where(sel, nn, wn) for nn, wn in zip(n, w_n)]
        w_mat = [torch.where(sel, r[mb + 1 + j], wm) for j, wm in enumerate(w_mat)]
    w_ar, w_ag, w_ab, w_par, w_er, w_eg, w_eb = w_mat
    w_nx, w_ny, w_nz = w_n

    valid = w_kind >= 0.0

    def is_kind(k):
        return w_kind == float(k)

    # -- face the normal toward the ray ------------------------------------
    d_dot_n = dx * w_nx + dy * w_ny + dz * w_nz
    front = d_dot_n < flt_eps
    sgn = _where(front, 1.0, -1.0)
    nx_, ny_, nz_ = w_nx * sgn, w_ny * sgn, w_nz * sgn

    il = _rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-30))
    ux, uy, uz = dx * il, dy * il, dz * il

    phi = 6.283185307179586 * u1
    cos_phi, sin_phi = _cos(phi), _sin(phi)

    def azimuth(z):
        rr = _sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        return rr * cos_phi, rr * sin_phi, z

    def normalize3(x, y, z):
        inv = _rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
        return x * inv, y * inv, z * inv

    u_dot_n = ux * nx_ + uy * ny_ + uz * nz_
    mx = ux - 2.0 * u_dot_n * nx_
    my = uy - 2.0 * u_dot_n * ny_
    mz = uz - 2.0 * u_dot_n * nz_

    avx, avy, avz = azimuth(1.0 - 2.0 * u0)
    if LAMBERTIAN in used:
        lrx, lry, lrz = nx_ + avx, ny_ + avy, nz_ + avz
        nzero = (lrx.abs() < 1e-8) & (lry.abs() < 1e-8) & (lrz.abs() < 1e-8)
        lrx = torch.where(nzero, nx_, lrx)
        lry = torch.where(nzero, ny_, lry)
        lrz = torch.where(nzero, nz_, lrz)
        sdx, sdy, sdz = normalize3(lrx, lry, lrz)
    else:
        sdx, sdy, sdz = nx_, ny_, nz_

    def frame_lobe(ax, ay, az, cos_t):
        s = _where(az >= 0.0, 1.0, -1.0)
        a_ = -1.0 / (s + az)
        b = ax * ay * a_
        t0x, t0y, t0z = 1.0 + s * ax * ax * a_, s * b, -s * ax
        t1x, t1y, t1z = b, s + ay * ay * a_, -ay
        sin_t = _sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cp, sp = cos_phi * sin_t, sin_phi * sin_t
        return (t0x * cp + t1x * sp + ax * cos_t,
                t0y * cp + t1y * sp + ay * cos_t,
                t0z * cp + t1z * sp + az * cos_t)

    def pick(sel, g, cur):
        return [torch.where(sel, gi, ci) for gi, ci in zip(g, cur)]

    sd = [sdx, sdy, sdz]
    at = [w_ar, w_ag, w_ab]
    scattered = ~is_kind(EMISSION)
    one = torch.ones_like(ox)

    if METAL in used:
        fuzz = torch.clamp_max(w_par, 1.0)
        ballr = _exp(_div(_log(torch.clamp_min(u2, 1e-12)), 3.0))
        bx, by, bz = avx * ballr, avy * ballr, avz * ballr
        mrx, mry, mrz = mx + fuzz * bx, my + fuzz * by, mz + fuzz * bz
        metal_ok = (mrx * nx_ + mry * ny_ + mrz * nz_) > 0.0
        g = normalize3(torch.where(metal_ok, mrx, mx),
                       torch.where(metal_ok, mry, my),
                       torch.where(metal_ok, mrz, mz))
        sel = is_kind(METAL)
        sd = pick(sel, g, sd)
        okf = metal_ok.to(torch.float32)
        at = pick(sel, (w_ar * okf, w_ag * okf, w_ab * okf), at)
        scattered = scattered & ~(sel & ~metal_ok)

    if DIELECTRIC in used:
        sel = is_kind(DIELECTRIC)
        ior = _where(sel & (w_par > 0.0), w_par, 1.5)
        eta = torch.where(front, 1.0 / ior, ior)
        cos_t = torch.clamp_max(-(ux * nx_ + uy * ny_ + uz * nz_), 1.0)
        sin_t = _sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        cannot = eta * sin_t > 1.0
        r0s = (1.0 - eta) / (1.0 + eta)
        r0s = r0s * r0s
        omc = 1.0 - cos_t
        omc2 = omc * omc
        rp = r0s + (1.0 - r0s) * omc2 * omc2 * omc
        choose = cannot | (rp > u2)
        px_ = eta * (ux + cos_t * nx_)
        py_ = eta * (uy + cos_t * ny_)
        pz_ = eta * (uz + cos_t * nz_)
        k = 1.0 - (px_ * px_ + py_ * py_ + pz_ * pz_)
        pos = k > 0.0
        rpar = _where(pos, _sqrt(_where(pos, k, 1.0)), 0.0)
        g = normalize3(torch.where(choose, mx, px_ - rpar * nx_),
                       torch.where(choose, my, py_ - rpar * ny_),
                       torch.where(choose, mz, pz_ - rpar * nz_))
        sd = pick(sel, g, sd)
        at = pick(sel, (one, one, one), at)

    if PHONG_METAL in used:
        sel = is_kind(PHONG_METAL)
        pc = _exp(_log(torch.clamp_min(u0, 1e-12))
                  / (torch.clamp_min(w_par, 0.0) + 1.0))
        ax, ay, az = normalize3(mx, my, mz)
        sd = pick(sel, frame_lobe(ax, ay, az, pc), sd)

    if SPECULAR in used:
        sel = is_kind(SPECULAR)
        sd = pick(sel, normalize3(mx, my, mz), sd)

    if COAT in used:
        sel = is_kind(COAT)
        spec = u2 < 0.05
        ccos = _sqrt(torch.clamp_min(1.0 - u0, 0.0))
        g = frame_lobe(nx_, ny_, nz_, ccos)
        g = pick(spec, (mx, my, mz), g)
        sd = pick(sel, g, sd)
        specf = spec.to(torch.float32)
        at = pick(sel, tuple(specf + (1.0 - specf) * c for c in (w_ar, w_ag, w_ab)), at)

    if REFRACTION in used:
        sel = is_kind(REFRACTION)
        nt = _where(sel & (w_par > 0.0), w_par, 1.5)
        nnt = torch.where(front, 1.0 / nt, nt)
        ddn = ux * nx_ + uy * ny_ + uz * nz_
        cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
        tir = cos2t < 0.0
        cos_t = torch.clamp_max(-ddn, 1.0)
        px_ = nnt * (ux + cos_t * nx_)
        py_ = nnt * (uy + cos_t * ny_)
        pz_ = nnt * (uz + cos_t * nz_)
        k = 1.0 - (px_ * px_ + py_ * py_ + pz_ * pz_)
        pos = k > 0.0
        rpar = _where(pos, _sqrt(_where(pos, k, 1.0)), 0.0)
        tdx, tdy, tdz = normalize3(px_ - rpar * nx_, py_ - rpar * ny_,
                                   pz_ - rpar * nz_)
        q = (nt - 1.0) / (nt + 1.0)
        r0s = q * q
        c1m = 1.0 - torch.where(front, -ddn, tdx * nx_ + tdy * ny_ + tdz * nz_)
        c1m2 = c1m * c1m
        re = r0s + (1.0 - r0s) * c1m2 * c1m2 * c1m
        prob = 0.25 + 0.5 * re
        choose = tir | (u2 < prob)
        g = pick(choose, normalize3(mx, my, mz), (tdx, tdy, tdz))
        sd = pick(sel, g, sd)
        w = _where(tir, 1.0, torch.where(choose, re / prob, (1.0 - re) / (1.0 - prob)))
        at = pick(sel, (w_ar * w, w_ag * w, w_ab * w), at)

    # -- bookkeeping (all rays here are alive) ------------------------------
    if inp.sky:
        t_sky = 0.5 * (uy + 1.0)
        sky = [wh + t_sky * float(np.float32(bl - wh))
               for wh, bl in zip(SKY_WHITE, SKY_BLUE)]
        missf = (~valid).to(torch.float32)
        rx = rx + missf * tpx * sky[0]
        ry = ry + missf * tpy * sky[1]
        rz = rz + missf * tpz * sky[2]
    if inp.additive_emission:
        hitf = valid.to(torch.float32)
        rx = rx + hitf * tpx * w_er
        ry = ry + hitf * tpy * w_eg
        rz = rz + hitf * tpz * w_eb
    if EMISSION in used:
        termf = (valid & is_kind(EMISSION)).to(torch.float32)
        rx = rx + termf * tpx * w_ar * w_par
        ry = ry + termf * tpy * w_ag * w_par
        rz = rz + termf * tpz * w_ab * w_par

    cont = valid & scattered
    contf = cont.to(torch.float32)
    ntpx = tpx * (1.0 - contf + contf * at[0])
    ntpy = tpy * (1.0 - contf + contf * at[1])
    ntpz = tpz * (1.0 - contf + contf * at[2])

    if inp.russian_roulette:
        p = torch.clamp(torch.maximum(torch.maximum(ntpx, ntpy), ntpz), 0.05, 1.0)
        survive = (u3 < p) if do_rr else torch.ones_like(cont)
        bf = (cont & survive).to(torch.float32) if do_rr else torch.zeros_like(ox)
        inv_p = 1.0 / p
        ntpx = ntpx * (1.0 - bf + bf * inv_p)
        ntpy = ntpy * (1.0 - bf + bf * inv_p)
        ntpz = ntpz * (1.0 - bf + bf * inv_p)
        cont = cont & survive

    safe_t = _where(valid, best_t, 0.0)
    new_ray = (
        torch.where(cont, ox + safe_t * dx, ox),
        torch.where(cont, oy + safe_t * dy, oy),
        torch.where(cont, oz + safe_t * dz, oz),
        torch.where(cont, sd[0], dx),
        torch.where(cont, sd[1], dy),
        torch.where(cont, sd[2], dz),
        tm,
    )
    return new_ray, (ntpx, ntpy, ntpz), (rx, ry, rz), cont


def _trace(ray, pid, b0: int, b1: int, inp: SceneInputs, rows) -> torch.Tensor:
    """The bounce loop of the plain versions over one sample's rays:
    radiance (N, 3).

    Each bounce runs on the rays still alive (a dead ray's bounce is the
    identity in the kernels, so dropping it changes nothing); a ray's
    radiance is written out when it dies or the bounces run out.
    """
    n = pid.shape[0]
    dev = pid.device
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    tp = (ones, ones, ones)
    rad = (ones * 0.0, ones * 0.0, ones * 0.0)
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    idx = torch.arange(n, device=dev)
    for b in range(inp.bounces):
        if idx.numel() == 0:
            break
        WORK["bounces"] += idx.numel()
        h = pcg4d(pid[idx], b0, b + 1, b1)
        u = tuple(to_uniform(x) for x in h)
        ray, tp, rad, cont = _bounce(ray, tp, rad, u, b >= inp.rr_start,
                                     inp, rows)
        done = ~cont
        out[idx[done]] = torch.stack(rad, dim=-1)[done]
        idx = idx[cont]
        ray = tuple(x[cont] for x in ray)
        tp = tuple(x[cont] for x in tp)
        rad = tuple(x[cont] for x in rad)
    if idx.numel():
        out[idx] = torch.stack(rad, dim=-1)
    return out


def render_reference(inp: RenderInputs) -> torch.Tensor:
    """Plain K1: vectorized torch over the pass's pixels, sample by sample."""
    rows = inp.rows
    pid = inp.pid.to(torch.int64)
    acc = torch.zeros((pid.shape[0], 3), dtype=torch.float32, device=pid.device)
    words = inp.words.cpu().numpy().view(np.uint32)
    for s in range(words.shape[0]):
        b0, b1 = int(words[s, 0]), int(words[s, 1])
        ray = raygen(pid, b0, b1, inp.frame, inp.width, inp.height)
        acc = acc + _trace(ray, pid, b0, b1, inp, rows)
    return acc


def path_reference(inp: PathInputs) -> torch.Tensor:
    """Plain K2: the bounce loop on the supplied rays."""
    ray = (*inp.origin.unbind(1), *inp.direction.unbind(1), inp.time)
    return _trace(ray, inp.pid.to(torch.int64), *inp.words, inp, inp.rows)


def bounce_reference(inp: BounceInputs) -> tuple:
    """Plain K0: one bounce on the live rays of the carry; the dead pass
    through. Returns (the 12 (N,) float32 rows of the carry without the
    time row, (N,) int32 alive)."""
    state = torch.stack(inp.carry)
    out = torch.cat([state[0:6], state[7:13]])
    alive = torch.zeros_like(inp.alive)
    idx = torch.nonzero(inp.alive).flatten()
    if idx.numel() > 0:
        WORK["bounces"] += idx.numel()
        live = state[:, idx]
        ray, tp, rad, cont = _bounce(tuple(live[0:7]), tuple(live[7:10]),
                                     tuple(live[10:13]),
                                     tuple(inp.u4[idx].unbind(1)),
                                     inp.do_rr, inp, inp.rows)
        out[:, idx] = torch.stack([*ray[0:6], *tp, *rad])
        alive[idx] = cont.to(torch.int32)
    return tuple(out.unbind(0)), alive


__all__ = [
    "BOUNCE_BVH_LAUNCHES", "BOUNCE_LAUNCHES", "BounceInputs", "ForwardOnly",
    "KERNEL_BVH_LAUNCHES", "KERNEL_LAUNCHES", "MAT_ROWS", "PATH_BVH_LAUNCHES",
    "PATH_LAUNCHES", "PathInputs", "RenderInputs", "SceneInputs",
    "bounce_inputs", "bounce_kernel", "bounce_reference", "bounce_step",
    "bounce_step_reference", "device_or_raise", "grad_probe", "guard", "pack_frame",
    "pack_scene_shaded", "path_inputs", "path_kernel", "path_reference",
    "path_trace", "path_trace_reference", "planar_state", "render_inputs",
    "render_kernel", "render_reference", "render_samples",
    "render_samples_reference", "scene_inputs",
]
