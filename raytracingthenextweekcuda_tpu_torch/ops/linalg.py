"""Vector math over trailing-axis-3 tensors (counterpart of
raytracingthenextweekcuda_tpu/ops/linalg.py).

Sums are written out term by term, in the reference's order, so float32
results round as the reference's do. Square roots are taken in float64
and rounded, which is the correctly rounded float32 square root on every
device.
"""

from __future__ import annotations

import torch

from raytracingthenextweekcuda_tpu_torch.ops.fmath import sqrt


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize: the zero vector maps to zero."""
    norm_sq = dot(v, v)
    pos = norm_sq > 0.0
    safe = torch.where(pos, norm_sq, torch.ones_like(norm_sq))
    inv = torch.where(pos, 1.0 / sqrt(safe), torch.zeros_like(norm_sq))
    return v * inv[..., None]


def lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a + t * (b - a)."""
    return a + t * (b - a)


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where every component is under 1e-8 in magnitude."""
    return (v.abs() < 1e-8).all(dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection v - 2 dot(v, n) n."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, eta_ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction of the unit vector `uv` about `n`; the square
    root's argument is clamped at grazing angles, as the reference's."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_out_perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    k = 1.0 - length_squared(r_out_perp)
    pos = k > 0.0
    r_par = torch.where(pos, sqrt(torch.where(pos, k, torch.ones_like(k))),
                        torch.zeros_like(k))
    return r_out_perp - r_par[..., None] * n


def rotate_y(v: torch.Tensor, degrees) -> torch.Tensor:
    """Rotate about +Y by `degrees` (LinearAlgebra.h rotateY), in v's dtype."""
    rad = torch.deg2rad(torch.as_tensor(degrees, dtype=v.dtype, device=v.device))
    c, s = torch.cos(rad), torch.sin(rad)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)
