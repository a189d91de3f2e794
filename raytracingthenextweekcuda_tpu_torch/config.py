"""Render configuration (counterpart of raytracingthenextweekcuda_tpu/config.py).

Width, height, spp and bounces are plain runtime values here; the kernel
takes them as launch arguments.
"""

from __future__ import annotations

import dataclasses

# Math::epsilon — ray tMin and the plane denominator threshold.
EPSILON = 1e-3
# FLT_EPSILON — sphere discriminant and front-face tests use machine epsilon.
FLT_EPSILON = 1.1920929e-7
INFINITY = float("inf")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static parameters of a render; field for field the reference's."""

    width: int = 512
    height: int = 512
    spp: int = 32
    bounces: int = 10
    # Ray epsilon used as tMin on every bounce.
    tmin: float = EPSILON
    # Samples traced per pass; 0 means "all at once".
    spp_per_pass: int = 0
    russian_roulette: bool = False
    rr_start_bounce: int = 3
    # Sky gradient on a miss; black when False.
    sky_background: bool = True
    # Root of the key tree (threefry key words, ops/threefry.py).
    seed: int = 1984
    # Render finalized scenes with the forward-only kernels (K1 per pass, K2
    # per wavefront). False selects the differentiable torch wavefront
    # (models/integrator.py); tile-BVH scenes take the sorted wavefront,
    # which is differentiable, either way.
    fused_bounce: bool = True
    # Tile-BVH scenes: sort the wavefront by the coherence key before
    # every `sort_stride`-th bounce from the second on (models/integrator.
    # _trace_sorted); False keeps it unsorted. Neither changes the image.
    sort_rays: bool = True
    sort_stride: int = 1

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def passes(self) -> list[int]:
        """Split ``spp`` into per-pass sample counts."""
        chunk = self.spp_per_pass if self.spp_per_pass > 0 else self.spp
        chunk = max(1, min(chunk, self.spp))
        counts = [chunk] * (self.spp // chunk)
        if self.spp % chunk:
            counts.append(self.spp % chunk)
        return counts
