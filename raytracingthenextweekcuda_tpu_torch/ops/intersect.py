"""Batched ray-primitive intersection in plain torch (counterpart of
raytracingthenextweekcuda_tpu/ops/intersect.py).

Each function intersects a wavefront of R rays with every primitive of one
type at once, as (R, P) tensors, and reduces to each ray's closest hit. It
serves scenes that were not finalized (no pack), such as the scenes that
`apps/fit.py` builds from parameters. The scene's leaves may be numpy
arrays or torch tensors; `t`, the normals and the hit points are
differentiable with respect to sphere centres and radii, plane positions
and triangle vertices, while the choice of the closest primitive is
discrete (piecewise constant).
"""

from __future__ import annotations

import torch

from raytracingthenextweekcuda_tpu_torch.config import EPSILON, FLT_EPSILON
from raytracingthenextweekcuda_tpu_torch.ops import fmath, linalg
from raytracingthenextweekcuda_tpu_torch.ops.geometry import (
    PLANE_XY,
    PLANE_YZ,
    Planes,
    Spheres,
    Triangles,
)
from raytracingthenextweekcuda_tpu_torch.ops.rays import Hit, Rays, face_normal


def leaf(x, device, dtype=torch.float32) -> torch.Tensor:
    """A scene leaf (numpy array or tensor) as a tensor on `device`; a
    tensor keeps its autograd graph."""
    return torch.as_tensor(x, device=device).to(dtype)


def _reduce_closest(rays: Rays, t, valid, outward_fn, material_id) -> Hit:
    """Each ray's closest valid candidate of (R, P) `t` (the first of equal
    minima), as a Hit; `outward_fn(best, best_t)` gives the winners'
    outward normals."""
    inf = torch.full_like(t, float("inf"))
    t_masked = torch.where(valid, t, inf)
    best = torch.argmin(t_masked, dim=1)
    best_t = t_masked.gather(1, best[:, None])[:, 0]
    any_valid = torch.isfinite(best_t)
    outward = outward_fn(best, torch.where(any_valid, best_t,
                                           torch.zeros_like(best_t)))
    front, normal = face_normal(rays.direction, outward)
    return Hit(
        t=best_t,
        normal=torch.where(any_valid[:, None], normal, torch.zeros_like(normal)),
        front_face=front & any_valid,
        material_id=torch.where(any_valid, material_id[best],
                                torch.full_like(best, -1)),
        valid=any_valid,
    )


def intersect_spheres(rays: Rays, spheres: Spheres, tmin, tmax) -> Hit:
    """Quadratic test with the nearest root in [tmin, tmax]; the centre is
    lerped to each ray's shutter time, and a negative radius flips the
    normal."""
    dev = rays.origin.device
    c0 = leaf(spheres.center0, dev)
    c1 = leaf(spheres.center1, dev)
    t0 = leaf(spheres.time0, dev)
    t1 = leaf(spheres.time1, dev)
    radius = leaf(spheres.radius, dev)
    w = (rays.time[:, None] - t0[None, :]) / (t1 - t0)[None, :]
    centers = c0[None, :, :] + w[..., None] * (c1 - c0)[None, :, :]  # (R, S, 3)
    oc = rays.origin[:, None, :] - centers
    d = rays.direction[:, None, :]
    a = linalg.length_squared(rays.direction)[:, None]
    half_b = linalg.dot(oc, d)
    c = linalg.length_squared(oc) - (radius * radius)[None, :]
    disc = half_b * half_b - a * c
    has_root = disc > FLT_EPSILON
    sqrt_disc = fmath.sqrt(torch.where(has_root, disc, torch.ones_like(disc)))
    inv_a = 1.0 / a
    root0 = (-half_b - sqrt_disc) * inv_a
    root1 = (-half_b + sqrt_disc) * inv_a
    in0 = (root0 >= tmin) & (root0 <= tmax)
    in1 = (root1 >= tmin) & (root1 <= tmax)
    t = torch.where(in0, root0, root1)
    valid = has_root & (in0 | in1)

    def outward(best, best_t):
        center = centers[torch.arange(best.shape[0], device=dev), best]
        return (rays.at(best_t) - center) / linalg.take_scalar(radius, best)[:, None]

    return _reduce_closest(rays, t, valid, outward,
                           leaf(spheres.material_id, dev, torch.int64))


def intersect_planes(rays: Rays, planes: Planes, tmin, tmax) -> Hit:
    """Finite axis-oriented planes: t in [tmin, tmax), the denominator gate
    |d.n| > EPSILON when two-sided else d.n > EPSILON, and a strict test
    of the two axes the orientation names."""
    dev = rays.origin.device
    position = leaf(planes.position, dev)
    normal = leaf(planes.normal, dev)
    extend = leaf(planes.extend, dev)
    two_sided = leaf(planes.two_sided, dev, torch.bool)
    orient = leaf(planes.orientation, dev, torch.int64)[None, :]
    denom = linalg.dot(normal[None, :, :], rays.direction[:, None, :])
    proceed = torch.where(two_sided[None, :], denom.abs() > EPSILON,
                          denom > EPSILON)
    po = position[None, :, :] - rays.origin[:, None, :]
    denom_safe = torch.where(proceed, denom, torch.ones_like(denom))
    t = linalg.dot(po, normal[None, :, :]) / denom_safe
    hit_pos = rays.origin[:, None, :] + t[..., None] * rays.direction[:, None, :]
    lo = position - extend
    hi = position + extend
    inside = (hit_pos > lo[None, :, :]) & (hit_pos < hi[None, :, :])
    in_x, in_y, in_z = inside[..., 0], inside[..., 1], inside[..., 2]
    in_range = torch.where(orient == PLANE_XY, in_x & in_y,
                           torch.where(orient == PLANE_YZ, in_y & in_z,
                                       in_x & in_z))
    valid = proceed & in_range & (t >= tmin) & (t < tmax)
    return _reduce_closest(rays, t, valid,
                           lambda best, _: linalg.take_rows(normal, best),
                           leaf(planes.material_id, dev, torch.int64))


def moller_trumbore(rays: Rays, vertices, tmin, tmax, backface_cull: bool = True):
    """Möller–Trumbore over all (ray, triangle) pairs of (T, 3, 3)
    `vertices`: ((R, T) t, (R, T) valid, (T, 3) unnormalized geometric
    normals). Back faces are culled by det > FLT_EPSILON; the barycentric
    bounds are strict and t lies in (tmin, tmax)."""
    v0 = vertices[:, 0, :]
    e1 = vertices[:, 1, :] - v0
    e2 = vertices[:, 2, :] - v0
    d = rays.direction[:, None, :]
    pvec = linalg.cross(d, e2[None, :, :])
    det = linalg.dot(e1[None, :, :], pvec)
    det_ok = det > FLT_EPSILON if backface_cull else det.abs() > FLT_EPSILON
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tvec = rays.origin[:, None, :] - v0[None, :, :]
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1[None, :, :])
    v = linalg.dot(d, qvec) * inv_det
    t = linalg.dot(e2[None, :, :], qvec) * inv_det
    valid = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return t, valid, linalg.cross(e1, e2)


def intersect_triangles(rays: Rays, triangles: Triangles, tmin, tmax,
                        backface_cull: bool = True) -> Hit:
    """Brute-force closest hit over a triangle soup."""
    dev = rays.origin.device
    t, valid, geom_n = moller_trumbore(
        rays, leaf(triangles.vertices, dev).reshape(-1, 3, 3), tmin, tmax,
        backface_cull)
    return _reduce_closest(rays, t, valid,
                           lambda best, _: linalg.normalize(linalg.take_rows(geom_n, best)),
                           leaf(triangles.material_id, dev, torch.int64))


__all__ = ["intersect_planes", "intersect_spheres", "intersect_triangles",
           "leaf", "moller_trumbore"]
