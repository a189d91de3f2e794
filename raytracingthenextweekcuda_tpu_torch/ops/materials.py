"""Branchless BSDF of the wavefront bounce (counterpart of
raytracingthenextweekcuda_tpu/ops/materials.py).

Every material kind present in the scene is evaluated for every ray and
blended by kind masks, on a pre-drawn (N, 4) uniform block: slot 0 the
polar or lobe shape, slot 1 the azimuth, slot 2 the secondary draw (fuzz
radius or branch choice); slot 3 is left to Russian roulette. The
arithmetic follows the reference's order; transcendentals go through
ops/fmath.py so the CPU and the card give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracingthenextweekcuda_tpu_torch.ops import fmath, linalg, sampling
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
from raytracingthenextweekcuda_tpu_torch.ops.intersect import leaf
from raytracingthenextweekcuda_tpu_torch.ops.linalg import take_rows, take_scalar
from raytracingthenextweekcuda_tpu_torch.ops.rays import Hit, Rays


class MaterialRows(NamedTuple):
    """Material rows: the table itself (M rows) or gathered per ray."""

    kind: torch.Tensor      # (M,) int64
    albedo: torch.Tensor    # (M, 3) float32
    param: torch.Tensor     # (M,) float32
    emission: torch.Tensor  # (M, 3) float32


def material_table(materials, device) -> MaterialRows:
    """A scene's Materials as a table on `device`; leaves that are tensors
    keep their autograd graph (albedos fitted by apps/fit.py)."""
    return MaterialRows(leaf(materials.kind, device, torch.int64),
                        leaf(materials.albedo, device),
                        leaf(materials.param, device),
                        leaf(materials.emission, device))


def gather(table: MaterialRows, material_id: torch.Tensor) -> MaterialRows:
    """Per-ray rows; an id < 0 (a miss) reads row 0, whose values the
    caller masks."""
    idx = torch.clamp_min(material_id, 0)
    return MaterialRows(table.kind[idx], take_rows(table.albedo, idx),
                        take_scalar(table.param, idx), take_rows(table.emission, idx))


class Scatter(NamedTuple):
    """Per-ray scatter decision."""

    direction: torch.Tensor    # (N, 3) unit: the next bounce's direction
    attenuation: torch.Tensor  # (N, 3) throughput factor when scattered
    scattered: torch.Tensor    # (N,) bool: False ends the path
    emitted: torch.Tensor      # (N, 3) radiance released when it ends


def schlick(cosine: torch.Tensor, eta_ratio: torch.Tensor) -> torch.Tensor:
    """Schlick's reflectance."""
    r0 = (1.0 - eta_ratio) / (1.0 + eta_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * fmath.pow(1.0 - cosine, 5.0)


def _fill(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def scatter(u: torch.Tensor, rays: Rays, hit: Hit, mat: MaterialRows,
            used_kinds: tuple | None = None) -> Scatter:
    """Scatter every ray by its material row, for the kinds in
    `used_kinds` (None: all kinds). `u` is the (N, >=3) uniform block.
    Rows of missed rays are garbage; callers mask by `hit.valid`."""
    def use(k):
        return used_kinds is None or k in used_kinds

    unit_dir = linalg.normalize(rays.direction)
    normal = hit.normal
    # One azimuth for every lobe: the kinds are exclusive per ray.
    phi = sampling.TWO_PI * u[:, 1]
    cos_phi = fmath.cos(phi)
    sin_phi = fmath.sin(phi)

    def azimuth_vec(z):
        r = fmath.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        return torch.stack([r * cos_phi, r * sin_phi, z], dim=-1)

    def frame_lobe(axis, cos_theta):
        t, b = sampling.orthonormal_basis(axis)
        sin_theta = fmath.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
        return (t * (cos_phi * sin_theta)[..., None]
                + b * (sin_phi * sin_theta)[..., None]
                + axis * cos_theta[..., None])

    if use(LAMBERTIAN):
        lamb_raw = normal + azimuth_vec(1.0 - 2.0 * u[:, 0])
        lamb_dir = linalg.normalize(torch.where(
            linalg.near_zero(lamb_raw)[..., None], normal, lamb_raw))
    else:
        lamb_dir = normal

    mirror = linalg.reflect(unit_dir, normal)
    if use(METAL):
        fuzz = torch.clamp_max(mat.param, 1.0)
        ball = (azimuth_vec(1.0 - 2.0 * u[:, 0])
                * fmath.pow(torch.clamp_min(u[:, 2], 1e-12), 1.0 / 3.0)[..., None])
        metal_raw = mirror + fuzz[..., None] * ball
        metal_ok = linalg.dot(metal_raw, normal) > 0.0
        metal_dir = linalg.normalize(
            torch.where(metal_ok[..., None], metal_raw, mirror))

    if use(DIELECTRIC):
        is_diel = mat.kind == DIELECTRIC
        ior = torch.where(is_diel & (mat.param > 0), mat.param,
                          _fill(mat.param, 1.5))
        eta = torch.where(hit.front_face, 1.0 / ior, ior)
        cos_theta = torch.clamp_max(linalg.dot(-unit_dir, normal), 1.0)
        sin_theta = fmath.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
        cannot_refract = eta * sin_theta > 1.0
        choose_reflect = cannot_refract | (schlick(cos_theta, eta) > u[:, 2])
        refracted = linalg.refract(unit_dir, normal, eta)
        diel_dir = linalg.normalize(
            torch.where(choose_reflect[..., None], mirror, refracted))

    if use(PHONG_METAL):
        phong_cos = fmath.pow(torch.clamp_min(u[:, 0], 1e-12),
                              1.0 / (torch.clamp_min(mat.param, 0.0) + 1.0))
        phong_dir = frame_lobe(linalg.normalize(mirror), phong_cos)

    if use(COAT):
        coat_spec = u[:, 2] < 0.05
        coat_diff_dir = frame_lobe(
            normal, fmath.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0)))
        coat_dir = torch.where(coat_spec[..., None], mirror, coat_diff_dir)
        coat_atten = torch.where(coat_spec[..., None],
                                 torch.ones_like(mat.albedo), mat.albedo)

    if use(REFRACTION):
        nt = torch.where((mat.kind == REFRACTION) & (mat.param > 0), mat.param,
                         _fill(mat.param, 1.5))
        nnt = torch.where(hit.front_face, 1.0 / nt, nt)
        ddn = linalg.dot(unit_dir, normal)
        cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
        tir = cos2t < 0.0
        tdir = linalg.normalize(linalg.refract(unit_dir, normal, nnt))
        q = (nt - 1.0) / (nt + 1.0)
        r0 = q * q
        c1m = 1.0 - torch.where(hit.front_face, -ddn, linalg.dot(tdir, normal))
        c1m2 = c1m * c1m
        re = r0 + (1.0 - r0) * (c1m2 * c1m2 * c1m)
        prob = 0.25 + 0.5 * re
        choose_refl = tir | (u[:, 2] < prob)
        refr_dir = torch.where(choose_refl[..., None],
                               linalg.normalize(mirror), tdir)
        refr_weight = torch.where(
            tir, _fill(re, 1.0),
            torch.where(choose_refl, re / prob, (1.0 - re) / (1.0 - prob)))
        refr_atten = mat.albedo * refr_weight[..., None]

    def is_kind(k):
        return mat.kind == k

    direction = lamb_dir
    if use(METAL):
        direction = torch.where(is_kind(METAL)[..., None], metal_dir, direction)
    if use(DIELECTRIC):
        direction = torch.where(is_kind(DIELECTRIC)[..., None], diel_dir, direction)
    if use(PHONG_METAL):
        direction = torch.where(is_kind(PHONG_METAL)[..., None], phong_dir, direction)
    if use(SPECULAR):
        direction = torch.where(is_kind(SPECULAR)[..., None],
                                linalg.normalize(mirror), direction)
    if use(COAT):
        direction = torch.where(is_kind(COAT)[..., None], coat_dir, direction)
    if use(REFRACTION):
        direction = torch.where(is_kind(REFRACTION)[..., None], refr_dir, direction)

    attenuation = mat.albedo
    if use(METAL):  # absorbed below the surface: no contribution
        attenuation = torch.where(is_kind(METAL)[..., None],
                                  mat.albedo * metal_ok[..., None].float(),
                                  attenuation)
    if use(DIELECTRIC):
        attenuation = torch.where(is_kind(DIELECTRIC)[..., None],
                                  torch.ones_like(mat.albedo), attenuation)
    if use(COAT):
        attenuation = torch.where(is_kind(COAT)[..., None], coat_atten, attenuation)
    if use(REFRACTION):
        attenuation = torch.where(is_kind(REFRACTION)[..., None], refr_atten,
                                  attenuation)

    scattered = ~is_kind(EMISSION)
    if use(METAL):
        scattered = scattered & ~(is_kind(METAL) & ~metal_ok)

    if use(EMISSION):
        emitted = torch.where(is_kind(EMISSION)[..., None],
                              mat.albedo * mat.param[..., None],
                              torch.zeros_like(mat.albedo))
    else:
        emitted = torch.zeros_like(mat.albedo)
    return Scatter(direction, attenuation, scattered, emitted)


__all__ = ["MaterialRows", "Scatter", "gather", "material_table", "schlick",
           "scatter"]
