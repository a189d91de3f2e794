"""Closed-form samplers on pre-drawn uniforms (counterpart of the
`*_from_uniforms` samplers and `orthonormal_basis` of
raytracingthenextweekcuda_tpu/ops/sampling.py). Transcendentals go through
ops/fmath.py, so the CPU and the card give the same bits."""

from __future__ import annotations

import torch

from raytracingthenextweekcuda_tpu_torch.ops import fmath

TWO_PI = 6.283185307179586


def orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless tangent frame (t, b) of unit normals `n` (..., 3)
    (Frisvad's construction with the sign fix)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, torch.ones_like(z), -torch.ones_like(z))
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t0 = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                      -sign * n[..., 0]], dim=-1)
    t1 = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t0, t1


def cosine_hemisphere_from_uniforms(u1, u2, normal: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about `normal`: phi = 2 pi u1, r =
    sqrt(u2), d = t cos(phi) r + b sin(phi) r + n sqrt(1 - u2)."""
    phi = TWO_PI * u1
    r = fmath.sqrt(u2)
    t, b = orthonormal_basis(normal)
    return (t * (fmath.cos(phi) * r)[..., None]
            + b * (fmath.sin(phi) * r)[..., None]
            + normal * fmath.sqrt(torch.clamp_min(1.0 - u2, 0.0))[..., None])


def phong_lobe_from_uniforms(u1, u2, axis: torch.Tensor, exponent) -> torch.Tensor:
    """Phong-lobe direction about the unit `axis`: cos(alpha) =
    u1^(1/(exponent+1)), phi = 2 pi u2."""
    cos_a = fmath.pow(u1, 1.0 / (exponent + 1.0))
    sin_a = fmath.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    phi = TWO_PI * u2
    t, b = orthonormal_basis(axis)
    return (t * (fmath.cos(phi) * sin_a)[..., None]
            + b * (fmath.sin(phi) * sin_a)[..., None]
            + axis * cos_a[..., None])


__all__ = ["orthonormal_basis", "cosine_hemisphere_from_uniforms",
           "phong_lobe_from_uniforms"]
