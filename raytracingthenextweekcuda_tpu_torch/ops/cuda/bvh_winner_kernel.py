"""Tile-BVH winner through per-block leaf work lists: the work-list build
and the winner kernel K4 (counterpart of
raytracingthenextweekcuda_tpu/ops/pallas/bvh_winner_kernel.py).

1. `build_worklist` (torch): slab-test every live ray against every leaf
   box, reduce per 128-ray block to (any hit, nearest entry) per leaf, and
   sort each block's hit leaves by entry distance. A leaf entered only
   behind a ray's analytic ceiling `tcap` is not listed for it. Above
   FRUSTUM_LEAF_THRESHOLD leaves a conservative packet-frustum pass, one
   interval slab test per block, replaces the per-ray pass; its lists are
   supersets and the kernel's per-ray re-check makes the extras inert.
2. K4 (csrc/bvh_winner_kernel.cu): per block, walk its list front to back
   up to the block's static horizon (the largest live ray's ceiling: its
   `tcap` capped by its padded root-box exit); for each leaf re-check the
   slab against each ray's live best t and let the rays that can still
   improve scan the leaf's real triangles (`LeafScene.leaf_count`, a
   prefix of its tile), several threads a ray when few need it. Returns
   (t, code), code = TYPE_TRIANGLE << 24 | padded triangle column, (BIG,
   -1) on a miss and for dead rays.

`intersect_packed_bvh` is the entry: tensors on a CUDA device launch K4
(or raise), tensors on the CPU run `winner_reference`, the same walk in
vectorized torch. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracingthenextweekcuda_tpu_torch.config import EPSILON, FLT_EPSILON
from raytracingthenextweekcuda_tpu_torch.ops.cuda.intersect_kernel import (
    BIG,
    TYPE_TRIANGLE,
)
from raytracingthenextweekcuda_tpu_torch.ops.cuda.work import (
    WORK,
    count_leaves,
    tile_triangles,
)
from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import safe_inv

# Rays per work-list block: one CTA of K4.
BLOCK = 128
# Above this many leaves the packet-frustum work-list pass takes over.
FRUSTUM_LEAF_THRESHOLD = 2048
# Rays per chunk of the exact work-list pass: bounds its (rays, leaves)
# temporaries.
_WL_CHUNK_RAYS = 1 << 20
# Blocks per chunk of the plain winner: bounds its (rays, tile) temporaries.
_WINNER_CHUNK_BLOCKS = 32
# Geometry rows of a Havel tile: n(3) dc e1p(3) d1 e2p(3) d2.
HAVEL_GEOM_ROWS = 12
# The root-exit margin of the horizon: exit * (1 + 1e-5) + 1e-4.
_EXIT_REL = 1.0 + 1e-5
_EXIT_ABS = 1e-4

# Launches of K4, counted by `winner` where it launches the kernel.
KERNEL_LAUNCHES = 0


def use_frustum_worklist(n_leaves: int) -> bool:
    """The packet-frustum pass above FRUSTUM_LEAF_THRESHOLD leaves."""
    return n_leaves > FRUSTUM_LEAF_THRESHOLD


class LeafScene(NamedTuple):
    """K4's scene on one device."""

    leaf_bounds: torch.Tensor  # (6, L) float32
    leaf_tiles: torch.Tensor   # (L,) int32: first triangle column of each leaf
    trih: torch.Tensor         # (12, L * tile) float32 Havel geometry rows
    root: torch.Tensor         # (6,) float32: union of the leaf boxes
    tile: int                  # triangles per leaf
    leaf_count: torch.Tensor   # (L,) int32: real columns of each tile (a prefix)
    aos: torch.Tensor          # (L * tile, 12) float32: trih column by column
    max_count: int             # the largest leaf_count: K4's leaf buffer width

    @property
    def n_leaves(self) -> int:
        return self.leaf_bounds.shape[1]


def real_columns(normals: torch.Tensor, first: torch.Tensor,
                 width: int) -> torch.Tensor:
    """(C,) int32: the columns of each leaf tile of `width` columns starting
    at `first` (C,) up to its last one with a nonzero normal in the Havel
    normal rows `normals` (3, columns). The tiles are filled from the front
    and zero-padded behind (ops/bvh_tile.py, permute_rows), and a zero
    normal fails the back-face test, so no column past this count can be
    hit."""
    cols = first.to(torch.int64)[:, None] + torch.arange(width, device=first.device)
    real = (normals[:, cols] != 0).any(dim=0)
    ends = torch.arange(1, width + 1, device=first.device)
    return torch.where(real, ends, 0).amax(dim=1).to(torch.int32)


def leaf_scene(packed, device) -> LeafScene:
    """K4's arrays of a tile-BVH pack, on `device`: the leaf boxes and
    tiles, the Havel geometry rows, each tile's real columns and the rows
    column by column (16-byte vectors that K4 stages a leaf from)."""
    if packed.leaf_bounds is None:
        raise ValueError("scene packed without a tile-BVH (models.scene.finalize)")
    lb = torch.from_numpy(packed.leaf_bounds.copy())
    L = lb.shape[1]
    tile = packed.trih.shape[1] // L
    tiles = torch.from_numpy(packed.leaf_tiles.reshape(-1).copy()).to(torch.int32)
    trih = torch.from_numpy(packed.trih[:HAVEL_GEOM_ROWS].copy())
    count = real_columns(trih[0:3], tiles, tile)
    return LeafScene(
        leaf_bounds=lb.to(device),
        leaf_tiles=tiles.to(device),
        trih=trih.to(device),
        root=torch.cat([lb[0:3].amin(dim=1), lb[3:6].amax(dim=1)]).to(device),
        tile=tile,
        leaf_count=count.to(device),
        aos=trih.t().contiguous().to(device),
        max_count=int(count.max()),
    )


class WorkList(NamedTuple):
    """Per-block front-to-back leaf lists: block b lists leaves
    order[b, :counts[b]] at ascending entry distances entry[b, :counts[b]]
    (+inf past the count)."""

    counts: torch.Tensor  # (B,) int32
    order: torch.Tensor   # (B, L) int32
    entry: torch.Tensor   # (B, L) float32


def _sorted_lists(hitb: torch.Tensor, tnb: torch.Tensor) -> WorkList:
    key = torch.where(hitb, tnb, torch.full_like(tnb, float("inf")))
    entry, order = torch.sort(key, dim=1, stable=True)
    return WorkList(hitb.sum(dim=1).to(torch.int32), order.to(torch.int32), entry)


def build_worklist(origin: torch.Tensor, direction: torch.Tensor,
                   alive: torch.Tensor, leaf_bounds: torch.Tensor, tmin: float,
                   tcap: torch.Tensor | None = None,
                   frustum: bool = False) -> WorkList:
    """Leaf work lists of 128-ray blocks.

    origin, direction (N, 3) with N a multiple of BLOCK; alive (N,) bool;
    leaf_bounds (6, L); tcap (N,) each ray's analytic ceiling (BIG when
    None). `frustum` selects the packet-frustum pass (see the module
    docstring; callers resolve it with use_frustum_worklist).
    """
    n = origin.shape[0]
    if n % BLOCK:
        raise ValueError(f"{n} rays is not a multiple of {BLOCK}")
    if tcap is None:
        tcap = torch.full((n,), BIG, dtype=torch.float32, device=origin.device)
    if frustum:
        return _build_worklist_frustum(origin, direction, alive, leaf_bounds,
                                       tmin, tcap)
    L = leaf_bounds.shape[1]
    lo, hi = leaf_bounds[0:3], leaf_bounds[3:6]
    hits, entries = [], []
    for c0 in range(0, n, _WL_CHUNK_RAYS):
        o = origin[c0: c0 + _WL_CHUNK_RAYS]
        d = direction[c0: c0 + _WL_CHUNK_RAYS]
        tn = tf = None
        for a in range(3):
            inv = safe_inv(d[:, a])[:, None]
            t0 = (lo[a][None, :] - o[:, a][:, None]) * inv
            t1 = (hi[a][None, :] - o[:, a][:, None]) * inv
            tna, tfa = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = tna if tn is None else torch.maximum(tn, tna)
            tf = tfa if tf is None else torch.minimum(tf, tfa)
        hit = ((tf >= tn) & (tf >= tmin)
               & (tn <= tcap[c0: c0 + _WL_CHUNK_RAYS, None])
               & alive[c0: c0 + _WL_CHUNK_RAYS, None])
        tnm = torch.where(hit, tn, torch.full_like(tn, float("inf")))
        hits.append(hit.view(-1, BLOCK, L).any(dim=1))
        entries.append(tnm.view(-1, BLOCK, L).amin(dim=1))
    return _sorted_lists(torch.cat(hits), torch.cat(entries))


def _build_worklist_frustum(origin, direction, alive, leaf_bounds, tmin,
                            tcap) -> WorkList:
    """Packet-frustum lists, O(blocks x leaves): an interval slab test of
    each block's live origin box and direction interval against each leaf
    box (all endpoint products; an axis whose direction interval spans 0
    is unconstrained). Lists are supersets of the exact pass's."""
    B = origin.shape[0] // BLOCK
    av = alive.view(B, BLOCK)
    inf = float("inf")

    def bounds(c):
        cb = c.view(B, BLOCK)
        return (torch.where(av, cb, torch.full_like(cb, inf)).amin(dim=1),
                torch.where(av, cb, torch.full_like(cb, -inf)).amax(dim=1))

    tn_lo = tf_hi = None
    for a in range(3):
        o_lo, o_hi = bounds(origin[:, a].contiguous())
        d_lo, d_hi = bounds(direction[:, a].contiguous())
        ilo, ihi = safe_inv(d_lo)[:, None], safe_inv(d_hi)[:, None]
        lo_a, hi_a = leaf_bounds[a][None, :], leaf_bounds[3 + a][None, :]
        cands = []
        for num in (lo_a - o_hi[:, None], lo_a - o_lo[:, None],
                    hi_a - o_hi[:, None], hi_a - o_lo[:, None]):
            cands += [num * ilo, num * ihi]
        axis_min = axis_max = cands[0]
        for c in cands[1:]:
            axis_min = torch.minimum(axis_min, c)
            axis_max = torch.maximum(axis_max, c)
        span0 = ((d_lo < 0.0) & (d_hi > 0.0))[:, None]
        axis_min = torch.where(span0, torch.full_like(axis_min, -inf), axis_min)
        axis_max = torch.where(span0, torch.full_like(axis_max, inf), axis_max)
        tn_lo = axis_min if tn_lo is None else torch.maximum(tn_lo, axis_min)
        tf_hi = axis_max if tf_hi is None else torch.minimum(tf_hi, axis_max)
    tc_blk = torch.where(av, tcap.view(B, BLOCK),
                         torch.full_like(tcap.view(B, BLOCK), -inf)).amax(dim=1)
    hitb = ((tf_hi >= tn_lo) & (tf_hi >= tmin) & av.any(dim=1)[:, None]
            & (tn_lo <= tc_blk[:, None]))
    return _sorted_lists(hitb, tn_lo)


def intersect_packed_bvh(rays, scene: LeafScene, tmin: float = EPSILON,
                         alive=None, t_cap=None):
    """Closest triangle hit of `rays` through the tile-BVH `scene` (on the
    rays' device): (t (N,) float32, code (N,) int32), code = TYPE_TRIANGLE
    << 24 | column of the winning triangle in the packed (tile-ordered,
    padded) triangles, (BIG, -1) on a miss and where `alive` is False.
    `t_cap` (N,) is each ray's closest analytic hit (BIG where none): a
    triangle at t >= t_cap is never reported. Back faces are culled.
    """
    args = winner_inputs(rays, scene, tmin, alive, t_cap)
    t, code = winner(*args, scene, tmin)
    return t[:rays.count], code[:rays.count]


def winner_inputs(rays, scene: LeafScene, tmin: float, alive=None, t_cap=None):
    """K4's per-ray inputs, padded with dead rays to a multiple of BLOCK,
    and their work lists: (origin, direction, alive, tcap, WorkList)."""
    dev = rays.origin.device
    n = rays.count
    pad = -n % BLOCK
    f32 = torch.float32
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    origin, direction = rays.origin, rays.direction
    if pad:  # dead padding rays complete the last block
        origin = torch.cat([origin, torch.zeros((pad, 3), dtype=f32, device=dev)])
        direction = torch.cat([direction,
                               torch.zeros((pad, 3), dtype=f32, device=dev)])
        alive = torch.cat([alive, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    tcap = torch.full((n + pad,), BIG, dtype=f32, device=dev)
    if t_cap is not None:
        tcap[:n] = torch.clamp_max(t_cap.to(f32), BIG)
    wl = build_worklist(origin, direction, alive, scene.leaf_bounds, tmin,
                        tcap=tcap, frustum=use_frustum_worklist(scene.n_leaves))
    return origin, direction, alive, tcap, wl


def winner(origin, direction, alive, tcap, wl: WorkList, scene: LeafScene,
           tmin: float):
    """Dispatch by device: CUDA tensors launch K4, CPU tensors run the
    plain version. Rays are padded to a multiple of BLOCK."""
    dev = origin.device
    if dev.type == "cuda":
        return _launch(origin, direction, alive, tcap, wl, scene, tmin)
    if dev.type == "cpu":
        return winner_reference(origin, direction, alive, tcap, wl, scene, tmin)
    raise ValueError(f"unsupported device {dev}")


def _launch(origin, direction, alive, tcap, wl: WorkList, scene: LeafScene,
            tmin: float):
    global KERNEL_LAUNCHES
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    dev = origin.device
    n = origin.shape[0]
    B, L = n // BLOCK, scene.n_leaves
    for t, dtype, shape in ((origin, torch.float32, (n, 3)),
                            (direction, torch.float32, (n, 3)),
                            (alive, torch.bool, (n,)),
                            (tcap, torch.float32, (n,)),
                            (wl.counts, torch.int32, (B,)),
                            (wl.order, torch.int32, (B, L)),
                            (wl.entry, torch.float32, (B, L)),
                            (scene.root, torch.float32, (6,)),
                            (scene.leaf_bounds, torch.float32, (6, L)),
                            (scene.leaf_tiles, torch.int32, (L,)),
                            (scene.leaf_count, torch.int32, (L,)),
                            (scene.aos, torch.float32,
                             (L * scene.tile, HAVEL_GEOM_ROWS))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"K4 input {tuple(t.shape)} {t.dtype} on {t.device}: "
                             f"expected contiguous {shape} {dtype} on {dev}")
    if scene.aos.data_ptr() % 16:
        raise ValueError("K4 input aos: not aligned to 16 bytes")
    if not 0 <= scene.max_count <= scene.tile:
        raise ValueError(f"K4: leaf buffer of {scene.max_count} columns for "
                         f"tiles of {scene.tile}")
    if n % BLOCK:
        raise ValueError(f"K4: {n} rays is not a multiple of {BLOCK}")
    lib = build.load()
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    code = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, code
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtnw_bvh_winner(
            origin.data_ptr(), direction.data_ptr(), alive.data_ptr(),
            tcap.data_ptr(), int(B), wl.counts.data_ptr(), wl.order.data_ptr(),
            wl.entry.data_ptr(), int(L), scene.root.data_ptr(),
            scene.leaf_bounds.data_ptr(), scene.leaf_tiles.data_ptr(),
            scene.leaf_count.data_ptr(), scene.aos.data_ptr(),
            int(scene.max_count), float(tmin), t_out.data_ptr(),
            code.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"K4 launch failed: {lib.rtnw_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES += 1
    return t_out, code


def _slab(lb, l, o, inv):
    """(tn, tf) of rays (C, BLOCK) against leaf boxes lb[:, l] (one per
    block), in the kernel's axis order."""
    tn = tf = None
    for a in range(3):
        t0 = (lb[a, l][:, None] - o[..., a]) * inv[..., a]
        t1 = (lb[3 + a, l][:, None] - o[..., a]) * inv[..., a]
        tna, tfa = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = tna if tn is None else torch.maximum(tn, tna)
        tf = tfa if tf is None else torch.minimum(tf, tfa)
    return tn, tf


def winner_reference(origin, direction, alive, tcap, wl: WorkList,
                     scene: LeafScene, tmin: float):
    """Plain K4: the walk vectorized over blocks, one list position at a
    time, each Havel tile evaluated over (rays, tile) in block chunks.

    A ray keeps the first lane of a tile's strict minimum below its best,
    as the kernel's sequential scan does, so the two agree bit for bit.
    """
    n = origin.shape[0]
    dev = origin.device
    B = n // BLOCK
    f32 = torch.float32
    t_out = torch.full((n,), BIG, dtype=f32, device=dev)
    code_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    av = alive.view(B, BLOCK)
    blocks = torch.nonzero(av.any(dim=1) & (wl.counts > 0)).flatten()
    if blocks.numel() == 0:
        return t_out, code_out
    o = origin.view(B, BLOCK, 3)[blocks]
    d = direction.view(B, BLOCK, 3)[blocks]
    live = av[blocks]
    inv = safe_inv(d)
    # Horizon: the live rays' ceiling, tcap capped by the padded root exit.
    tfr = None
    for a in range(3):
        t0 = (scene.root[a] - o[..., a]) * inv[..., a]
        t1 = (scene.root[3 + a] - o[..., a]) * inv[..., a]
        tfa = torch.maximum(t0, t1)
        tfr = tfa if tfr is None else torch.minimum(tfr, tfa)
    exit_pad = tfr * _EXIT_REL + _EXIT_ABS
    best = tcap.view(B, BLOCK)[blocks].clone()
    ceil0 = torch.minimum(best, torch.clamp_min(exit_pad, 0.0))
    tmax = torch.where(live, torch.minimum(best, ceil0),
                       torch.full_like(ceil0, float("-inf"))).amax(dim=1)
    code = torch.full(best.shape, -1, dtype=torch.int64, device=dev)
    counts = wl.counts[blocks]
    order = wl.order[blocks].to(torch.int64)
    entry = wl.entry[blocks]
    walking = torch.ones_like(counts, dtype=torch.bool)
    lane = torch.arange(scene.tile, device=dev)
    trih = scene.trih
    leaf_triangles = tile_triangles(trih[0:3], scene.leaf_tiles, scene.tile)
    for k in range(order.shape[1]):
        walking = walking & (k < counts) & (entry[:, k] < tmax)
        sel = torch.nonzero(walking).flatten()
        if sel.numel() == 0:
            break
        leaf = order[sel, k]
        tn, tf = _slab(scene.leaf_bounds, leaf, o[sel], inv[sel])
        WORK["box_tests"] += int(live[sel].sum())
        node_hit = (tf >= tn) & (tf >= tmin) & (tn < best[sel]) & live[sel]
        need = node_hit.any(dim=1)
        sel, leaf, node_hit = sel[need], leaf[need], node_hit[need]
        WORK["block_leaves"] += int(sel.numel())
        count_leaves(node_hit.sum(dim=1), leaf_triangles[leaf])
        for c0 in range(0, sel.numel(), _WINNER_CHUNK_BLOCKS):
            cs = sel[c0: c0 + _WINNER_CHUNK_BLOCKS]
            ts = scene.leaf_tiles[leaf[c0: c0 + _WINNER_CHUNK_BLOCKS]].to(torch.int64)
            h = trih[:, ts[:, None] + lane][:, :, None, :]  # (12, C, 1, tile)
            oc, dc_ = o[cs][..., None], d[cs][..., None]     # (C, BLOCK, 3, 1)
            ox, oy, oz = oc[:, :, 0], oc[:, :, 1], oc[:, :, 2]
            dx, dy, dz = dc_[:, :, 0], dc_[:, :, 1], dc_[:, :, 2]
            nx, ny, nz = h[0], h[1], h[2]
            dn = dx * nx + dy * ny + dz * nz
            ok = dn < -FLT_EPSILON
            inv_dn = 1.0 / torch.where(ok, dn, torch.ones_like(dn))
            t = (h[3] - (ox * nx + oy * ny + oz * nz)) * inv_dn
            hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
            u = h[4] * hx + h[5] * hy + h[6] * hz + h[7]
            v = h[8] * hx + h[9] * hy + h[10] * hz + h[11]
            b = best[cs]
            hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
                   & (t < b[..., None])
                   & node_hit[c0: c0 + _WINNER_CHUNK_BLOCKS][..., None])
            tm = torch.where(hit, t, torch.full_like(t, BIG))
            win = torch.argmin(tm, dim=-1)
            tile_best = tm.gather(-1, win[..., None])[..., 0]
            improved = tile_best < b
            best[cs] = torch.where(improved, tile_best, b)
            code[cs] = torch.where(improved, ts[:, None] + win, code[cs])
    found = code >= 0
    t_rows = torch.where(found, best, torch.full_like(best, BIG))
    c_rows = torch.where(found, (TYPE_TRIANGLE << 24) | code,
                         torch.full_like(code, -1)).to(torch.int32)
    ray_idx = (blocks[:, None] * BLOCK + torch.arange(BLOCK, device=dev)).flatten()
    t_out[ray_idx] = t_rows.flatten()
    code_out[ray_idx] = c_rows.flatten()
    return t_out, code_out


__all__ = ["BLOCK", "FRUSTUM_LEAF_THRESHOLD", "KERNEL_LAUNCHES", "LeafScene",
           "WorkList", "build_worklist", "intersect_packed_bvh", "leaf_scene",
           "real_columns", "use_frustum_worklist", "winner",
           "winner_inputs", "winner_reference"]
