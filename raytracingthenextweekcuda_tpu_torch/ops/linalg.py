"""Vector math over trailing-axis-3 tensors: what camera.derive uses
(counterpart of raytracingthenextweekcuda_tpu/ops/linalg.py).

Sums are written out term by term, in the reference's order, so float32
results round as the reference's do.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize: the zero vector maps to zero. The square root is
    taken in float64 and rounded, which is the correctly rounded float32
    square root on every device."""
    norm_sq = dot(v, v)
    pos = norm_sq > 0.0
    safe = torch.where(pos, norm_sq, torch.ones_like(norm_sq))
    inv = torch.where(pos, 1.0 / torch.sqrt(safe.double()).float(),
                      torch.zeros_like(norm_sq))
    return v * inv[..., None]
