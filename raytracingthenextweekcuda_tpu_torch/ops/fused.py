"""Scene intersection of the mesh path: K3 and K4 select the winner, the
hit record is recomputed from the winner's scene parameters (counterpart
of raytracingthenextweekcuda_tpu/ops/fused.py).

K3 covers the spheres and planes; on a tile-BVH scene K4 covers the mesh.
A ray whose slab test misses the mesh's root box, or whose closest
analytic hit lies in front of the root entry, is dead to K4, and each
ray's closest analytic hit seeds K4's search as a ceiling (`t_cap`). The
two winners merge by closest t; the mesh wins only when strictly closer or
when there is no analytic hit. The recompute reads the winning rows with
index gathers, from tables built of the scene's live leaves, so the hit
record is differentiable with respect to them while the selection is not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracingthenextweekcuda_tpu_torch.config import FLT_EPSILON
from raytracingthenextweekcuda_tpu_torch.ops import fmath, linalg
from raytracingthenextweekcuda_tpu_torch.ops.cuda.bvh_winner_kernel import (
    LeafScene,
    intersect_packed_bvh,
    leaf_scene,
)
from raytracingthenextweekcuda_tpu_torch.ops.cuda.intersect_kernel import (
    BIG,
    TYPE_PLANE,
    TYPE_SPHERE,
    TYPE_TRIANGLE,
    AnalyticRows,
    analytic_rows,
    intersect_packed,
)
from raytracingthenextweekcuda_tpu_torch.ops.intersect import leaf
from raytracingthenextweekcuda_tpu_torch.ops.linalg import take_rows
from raytracingthenextweekcuda_tpu_torch.ops.rays import Hit, Rays, face_normal
from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import safe_inv


class DeviceScene(NamedTuple):
    """What the mesh path reads each bounce, on one device: K3's rows, K4's
    leaves (None without a tile-BVH) and the winner tables of the
    recompute (spheres (S, 11): c0, c1, time0, time1, radius, material;
    planes (P, 7): position, normal, material; triangles (T, 10): three
    vertices, material)."""

    analytic: AnalyticRows
    leaves: LeafScene | None
    spheres: torch.Tensor
    planes: torch.Tensor
    triangles: torch.Tensor


def device_scene(scene, device) -> DeviceScene:
    """The DeviceScene of a finalized scene, in two parts as the reference
    splits them. Selection: K3's rows and K4's leaves come from the
    detached numpy rows of `scene.packed`, so the kernels get no gradient
    (the reference's stop_gradient). Recompute: the winner tables come from
    the scene's live leaves, which may be tensors that require grad, so
    gradients flow through `_recompute` into them."""
    packed = scene.packed
    tile_bvh = packed.leaf_bounds is not None
    return DeviceScene(
        analytic=analytic_rows(packed, device, include_triangles=not tile_bvh),
        leaves=leaf_scene(packed, device) if tile_bvh else None,
        **_recompute_tables(scene, device),
    )


def _recompute_tables(scene, device) -> dict:
    """The winner tables of the recompute, from the scene's leaves (numpy
    arrays or tensors, kept in the autograd graph)."""
    def table(*cols):
        return torch.cat([leaf(c, device).reshape(-1, w) for c, w in cols], dim=1)

    sph, pla, tri = scene.spheres, scene.planes, scene.triangles
    return dict(
        spheres=table((sph.center0, 3), (sph.center1, 3), (sph.time0, 1),
                      (sph.time1, 1), (sph.radius, 1), (sph.material_id, 1)),
        planes=table((pla.position, 3), (pla.normal, 3), (pla.material_id, 1)),
        triangles=table((tri.vertices, 9), (tri.material_id, 1)),
    )


def mesh_query(leaves: LeafScene, rays: Rays, tmin: float, alive, t_sel,
               code):
    """(alive_mesh, t_cap) of K4 from K3's (t_sel, code): the rays that
    hit the root box in front of their analytic hit, and each ray's
    analytic ceiling (BIG without an analytic hit)."""
    root = leaves.root
    inv = safe_inv(rays.direction)
    t0 = (root[None, 0:3] - rays.origin) * inv
    t1 = (root[None, 3:6] - rays.origin) * inv
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    rtn = torch.maximum(torch.maximum(tn[:, 0], tn[:, 1]), tn[:, 2])
    rtf = torch.minimum(torch.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
    root_hit = (rtf >= rtn) & (rtf >= tmin)
    alive_mesh = root_hit & ((code < 0) | (rtn <= t_sel))
    if alive is not None:
        alive_mesh = alive_mesh & alive
    return alive_mesh, torch.where(code >= 0, t_sel, torch.full_like(t_sel, BIG))


def intersect_scene_fused(dev_scene: DeviceScene, rays: Rays, tmin: float,
                          alive=None) -> Hit:
    """Closest hit of `rays` (see the module docstring). The selection
    sees the rays detached; the recompute sees them as they are."""
    sel = Rays(rays.origin.detach(), rays.direction.detach(),
               rays.time.detach())
    t_sel, code = intersect_packed(sel, dev_scene.analytic, tmin, alive=alive)
    if dev_scene.leaves is not None:
        alive_mesh, t_cap = mesh_query(dev_scene.leaves, sel, tmin, alive,
                                       t_sel, code)
        t_m, c_m = intersect_packed_bvh(sel, dev_scene.leaves, tmin,
                                        alive=alive_mesh, t_cap=t_cap)
        pick_mesh = (c_m >= 0) & ((t_m < t_sel) | (code < 0))
        t_sel = torch.where(pick_mesh, t_m, t_sel)
        code = torch.where(pick_mesh, c_m, code)
    return _recompute(dev_scene, rays, t_sel, code)


def _recompute(ds: DeviceScene, rays: Rays, t_sel, code) -> Hit:
    """The hit record of the selected winners, recomputed from their scene
    rows (reference fused.py:114-215)."""
    valid = code >= 0
    ptype = torch.where(valid, code >> 24, torch.zeros_like(code))
    idx = torch.where(valid, code & 0xFFFFFF, torch.zeros_like(code)).long()
    n = rays.count
    dev = rays.origin.device
    o, d = rays.origin, rays.direction
    t = torch.full((n,), float("inf"), device=dev)
    outward = torch.zeros((n, 3), device=dev)
    material_id = torch.full((n,), -1, dtype=torch.int64, device=dev)

    if ds.spheres.shape[0]:
        row = take_rows(ds.spheres, torch.where(ptype == TYPE_SPHERE, idx, 0))
        c0, c1 = row[:, 0:3], row[:, 3:6]
        t0, t1, radius = row[:, 6], row[:, 7], row[:, 8]
        w = (rays.time - t0) / (t1 - t0)
        center = c0 + w[:, None] * (c1 - c0)
        oc = o - center
        a = linalg.length_squared(d)
        half_b = linalg.dot(oc, d)
        c = linalg.length_squared(oc) - radius * radius
        disc = torch.clamp_min(half_b * half_b - a * c, 0.0)
        pos = disc > 0
        sq = fmath.sqrt(torch.where(pos, disc, torch.ones_like(disc))) * pos.float()
        r0 = (-half_b - sq) / a
        r1 = (-half_b + sq) / a
        t_sph = torch.where((r0 - t_sel).abs() <= (r1 - t_sel).abs(), r0, r1)
        n_sph = (rays.at(t_sph) - center) / radius[:, None]
        is_sph = valid & (ptype == TYPE_SPHERE)
        t = torch.where(is_sph, t_sph, t)
        outward = torch.where(is_sph[:, None], n_sph, outward)
        material_id = torch.where(is_sph, torch.round(row[:, 9]).long(),
                                  material_id)

    if ds.planes.shape[0]:
        row = take_rows(ds.planes, torch.where(ptype == TYPE_PLANE, idx, 0))
        position, normal = row[:, 0:3], row[:, 3:6]
        denom = linalg.dot(normal, d)
        denom = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
        t_pla = linalg.dot(position - o, normal) / denom
        is_pla = valid & (ptype == TYPE_PLANE)
        t = torch.where(is_pla, t_pla, t)
        outward = torch.where(is_pla[:, None], normal, outward)
        material_id = torch.where(is_pla, torch.round(row[:, 6]).long(),
                                  material_id)

    if ds.triangles.shape[0]:
        row = take_rows(ds.triangles, torch.where(ptype == TYPE_TRIANGLE, idx, 0))
        v0 = row[:, 0:3]
        e1 = row[:, 3:6] - v0
        e2 = row[:, 6:9] - v0
        det = linalg.dot(e1, linalg.cross(d, e2))
        inv_det = 1.0 / torch.where(det.abs() > FLT_EPSILON, det,
                                    torch.ones_like(det))
        t_tri = linalg.dot(e2, linalg.cross(o - v0, e1)) * inv_det
        n_tri = linalg.normalize(linalg.cross(e1, e2))
        is_tri = valid & (ptype == TYPE_TRIANGLE)
        t = torch.where(is_tri, t_tri, t)
        outward = torch.where(is_tri[:, None], n_tri, outward)
        material_id = torch.where(is_tri, torch.round(row[:, 9]).long(),
                                  material_id)

    front, normal = face_normal(d, outward)
    return Hit(t=t, normal=torch.where(valid[:, None], normal,
                                       torch.zeros_like(normal)),
               front_face=front & valid, material_id=material_id, valid=valid)


__all__ = ["DeviceScene", "device_scene", "intersect_scene_fused", "mesh_query"]
