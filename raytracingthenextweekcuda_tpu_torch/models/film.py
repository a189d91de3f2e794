"""Film: accumulation buffer and tonemap (counterpart of
raytracingthenextweekcuda_tpu/models/film.py).

u8 = 255.99 * clamp(sqrt(c), 0, 0.999), the reference's gamma, with the
square root correctly rounded in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Film:
    accum: torch.Tensor   # (H, W, 3) float32 running radiance sum
    sample_count: int     # samples accumulated per pixel

    @staticmethod
    def create(width: int, height: int, device="cpu") -> "Film":
        return Film(torch.zeros((height, width, 3), dtype=torch.float32,
                                device=device), 0)

    def add(self, radiance_sum: torch.Tensor, samples: int) -> "Film":
        """Accumulate the summed radiance of `samples` new samples/pixel."""
        return Film(self.accum + radiance_sum, self.sample_count + int(samples))

    @property
    def mean(self) -> torch.Tensor:
        scale = np.float32(1.0) / np.float32(max(self.sample_count, 1))
        return self.accum * float(scale)


def tonemap_u8(mean_radiance: torch.Tensor) -> torch.Tensor:
    """Gamma-2 tonemap to u8: 255.99 * clamp(sqrt(c), 0, 0.999)."""
    c = torch.sqrt(torch.clamp_min(mean_radiance, 0.0).double()).float()
    return (255.99 * torch.clamp(c, 0.0, 0.999)).to(torch.uint8)


def to_image(film: Film) -> np.ndarray:
    """(H, W, 3) u8 with row 0 at the image top (the film keeps y=0 at the
    bottom)."""
    return tonemap_u8(film.mean).cpu().numpy()[::-1]
