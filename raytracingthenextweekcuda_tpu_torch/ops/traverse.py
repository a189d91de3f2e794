"""Closest hit over a triangle mesh through its LBVH, as a lockstep walk of
per-ray stacks in plain torch (counterpart of
raytracingthenextweekcuda_tpu/ops/traverse.py).

Every ray carries its own stack as a row of an (N, STACK_SIZE) int32
tensor, and one loop steps all rays with a non-empty stack together:
pop a node; at an internal node test both children's boxes (bounded by
the ray's best t) and push the far, then the near child that it hits; at
a leaf run Möller–Trumbore on its triangle. The loop ends when every
stack is empty. Each step works on the rays whose stacks are not empty.

The walk selects and carries no gradient; `intersect_bvh` recomputes t
and the normal from the winning triangle's vertices, so they are
differentiable with respect to the vertices. The reference computes this
in XLA rather than in a Pallas kernel, and so does the port in torch ops.
"""

from __future__ import annotations

import torch

from raytracingthenextweekcuda_tpu_torch.config import FLT_EPSILON
from raytracingthenextweekcuda_tpu_torch.ops import linalg
from raytracingthenextweekcuda_tpu_torch.ops.bvh import BVH
from raytracingthenextweekcuda_tpu_torch.ops.intersect import leaf
from raytracingthenextweekcuda_tpu_torch.ops.rays import Hit, Rays, face_normal

# Karras trees over up to 2^20 triangles stay far below this depth.
STACK_SIZE = 64

# Steps of the walk since the last reset (one step pops one node of every
# live stack); chip_smoke.py reports them.
STEPS = 0


def _slab_test(origin, inv_dir, lo, hi, tmin, tmax):
    """Min/max AABB slab test: (hit, t_entry). IEEE inf handles
    axis-parallel rays."""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax)
    return hit, t_near


def _mt_single(origin, direction, v0, v1, v2, tmin, tmax, backface_cull):
    """Möller–Trumbore of one triangle per ray, all (N, 3): (t, u, v,
    valid)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = linalg.cross(direction, e2)
    det = linalg.dot(e1, pvec)
    det_ok = det > FLT_EPSILON if backface_cull else det.abs() > FLT_EPSILON
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tvec = origin - v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(direction, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    valid = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return t, u, v, valid


@torch.no_grad()
def traverse(rays: Rays, triangles, bvh: BVH, tmin, tmax,
             backface_cull: bool = True, alive=None):
    """Closest hit of every ray: (best_t, best_tri, u, v), best_tri the
    original triangle index, -1 on a miss (best_t is then `tmax`). Rays
    where the (N,) bool `alive` is False are not walked and miss."""
    global STEPS
    n = rays.count
    dev = rays.origin.device
    origin, direction = rays.origin.detach(), rays.direction.detach()
    inv_dir = 1.0 / direction  # inf on zero components is fine for slabs
    verts = leaf(triangles.vertices, dev).detach().reshape(-1, 3, 3)
    left, right = bvh.left.long(), bvh.right.long()
    tri_order = bvh.tri_order.long()
    n_int = bvh.num_internal

    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)  # stack[:, 0] = root
    if alive is not None:
        sp = sp * alive.to(torch.int64)
    best_t = torch.full((n,), float(tmax), dtype=origin.dtype, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)

    rows = torch.nonzero(sp > 0).flatten()
    while rows.numel():
        STEPS += 1
        o, inv, d, bt = origin[rows], inv_dir[rows], direction[rows], best_t[rows]
        sp_r = sp[rows] - 1
        node = stack[rows, sp_r.clamp(0, STACK_SIZE - 1)]
        is_leaf = node >= n_int

        # internal: test both children, push the far, then the near one
        inner = node.clamp(0, max(n_int - 1, 0))
        lchild, rchild = left[inner], right[inner]
        lhit, lt = _slab_test(o, inv, bvh.node_lo[lchild], bvh.node_hi[lchild],
                              tmin, bt)
        rhit, rt = _slab_test(o, inv, bvh.node_lo[rchild], bvh.node_hi[rchild],
                              tmin, bt)
        left_near = lt <= rt
        near = torch.where(left_near, lchild, rchild)
        far = torch.where(left_near, rchild, lchild)
        near_hit = torch.where(left_near, lhit, rhit)
        far_hit = torch.where(left_near, rhit, lhit)
        for push, child in ((~is_leaf & far_hit, far), (~is_leaf & near_hit, near)):
            slot = sp_r.clamp(0, STACK_SIZE - 1)
            keep = push & (sp_r < STACK_SIZE)  # a full stack drops the push
            stack[rows, slot] = torch.where(keep, child, stack[rows, slot])
            sp_r = sp_r + push.long()
        sp[rows] = sp_r

        # leaf: Möller–Trumbore on its triangle
        tri = tri_order[(node - n_int).clamp(0, bvh.num_leaves - 1)]
        tv = verts[tri]
        t, u, v, valid = _mt_single(o, d, tv[:, 0], tv[:, 1], tv[:, 2], tmin, bt,
                                    backface_cull)
        win = is_leaf & valid
        best_t[rows] = torch.where(win, t, bt)
        best_u[rows] = torch.where(win, u, best_u[rows])
        best_v[rows] = torch.where(win, v, best_v[rows])
        best_tri[rows] = torch.where(win, tri, best_tri[rows])
        rows = rows[sp_r > 0]
    return best_t, best_tri, best_u, best_v


def intersect_bvh(rays: Rays, triangles, bvh: BVH, tmin, tmax,
                  backface_cull: bool = True, alive=None) -> Hit:
    """The closest hit over a triangle soup through its BVH, as a Hit
    (no hit where `alive` is False).

    t and the normal are recomputed from the winning triangle's vertices
    (the scene's leaves, which may require grad), so they carry vertex
    gradients; the selection does not."""
    _, best_tri, _, _ = traverse(rays, triangles, bvh, tmin, tmax, backface_cull,
                                 alive)
    dev = rays.origin.device
    valid = best_tri >= 0
    tri = best_tri.clamp_min(0)
    tv = leaf(triangles.vertices, dev).reshape(-1, 3, 3)[tri]
    t, _, _, _ = _mt_single(rays.origin, rays.direction, tv[:, 0], tv[:, 1],
                            tv[:, 2], tmin, float("inf"), backface_cull)
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    geom_n = linalg.normalize(linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    front, normal = face_normal(rays.direction, geom_n)
    material_id = leaf(triangles.material_id, dev, torch.int64)[tri]
    return Hit(
        t=t,
        normal=torch.where(valid[:, None], normal, torch.zeros_like(normal)),
        front_face=front & valid,
        material_id=torch.where(valid, material_id, torch.full_like(material_id, -1)),
        valid=valid,
    )


__all__ = ["STACK_SIZE", "intersect_bvh", "traverse"]
