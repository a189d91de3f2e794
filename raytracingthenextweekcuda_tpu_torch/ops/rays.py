"""Ray and hit records of a wavefront, struct of arrays (counterpart of
raytracingthenextweekcuda_tpu/ops/rays.py)."""

from __future__ import annotations

import dataclasses

import torch

from raytracingthenextweekcuda_tpu_torch.config import FLT_EPSILON
from raytracingthenextweekcuda_tpu_torch.ops import linalg


@dataclasses.dataclass(frozen=True)
class Rays:
    """A wavefront of N rays."""

    origin: torch.Tensor     # (N, 3) float32
    direction: torch.Tensor  # (N, 3) float32, not necessarily unit length
    time: torch.Tensor       # (N,) float32 shutter time

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """origin + t * direction."""
        return self.origin + t[:, None] * self.direction

    @property
    def count(self) -> int:
        return self.origin.shape[0]

    def take(self, idx: torch.Tensor) -> "Rays":
        """The rays at `idx`, in that order."""
        return Rays(self.origin[idx], self.direction[idx], self.time[idx])


@dataclasses.dataclass(frozen=True)
class Hit:
    """Closest-hit record of N rays: `t` is +inf and `material_id` -1
    where there is no hit."""

    t: torch.Tensor            # (N,) float32
    normal: torch.Tensor       # (N, 3) float32, facing the incoming ray
    front_face: torch.Tensor   # (N,) bool
    material_id: torch.Tensor  # (N,) int64
    valid: torch.Tensor        # (N,) bool

    @staticmethod
    def none(n: int, device=None) -> "Hit":
        """The record of N rays that hit nothing."""
        return Hit(
            t=torch.full((n,), float("inf"), device=device),
            normal=torch.zeros((n, 3), device=device),
            front_face=torch.zeros((n,), dtype=torch.bool, device=device),
            material_id=torch.full((n,), -1, dtype=torch.int64, device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device),
        )


def face_normal(ray_dir: torch.Tensor, outward: torch.Tensor):
    """(front_face, oriented normal): front where dot(dir, outward) <
    FLT_EPSILON; the returned normal always opposes the incoming ray."""
    front = linalg.dot(ray_dir, outward) < FLT_EPSILON
    return front, torch.where(front[:, None], outward, -outward)


def closer(a: Hit, b: Hit) -> Hit:
    """Per ray, the nearer valid hit of two records (a wins ties)."""
    take_b = b.valid & (~a.valid | (b.t < a.t))
    return Hit(
        t=torch.where(take_b, b.t, a.t),
        normal=torch.where(take_b[:, None], b.normal, a.normal),
        front_face=torch.where(take_b, b.front_face, a.front_face),
        material_id=torch.where(take_b, b.material_id, a.material_id),
        valid=a.valid | b.valid,
    )


__all__ = ["Hit", "Rays", "closer", "face_normal"]
