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
    # Render each pass with the whole-render kernel. The port has only this
    # engine so far; False raises (see models/integrator.py).
    fused_bounce: bool = True
    # Coherence sort of tile-BVH wavefronts; kept for config parity, read
    # by no code of the port yet.
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
