"""Coherence key of the sorted wavefront (counterpart of
raytracingthenextweekcuda_tpu/ops/wavefront_sort.py).

Between bounces the wavefront is reordered by one int32 key per ray,

    alive ? miss_root << 30 | refined direction octant << 21 | morton
          : DEAD_KEY

so rays that start near each other and head the same way share a 128-ray
block of the work-list kernel K4, and dead rays gather at the tail. The
reorder is an argsort and index gathers; the final unsort is an index
scatter. Every random draw is a function of (pixel, sample key, bounce),
so the sorted render equals the unsorted one.
"""

from __future__ import annotations

import torch

# Dead-ray key: int32 max. Live keys are clamped below it, so the sorted
# key doubles as the alive mask (key != DEAD_KEY).
DEAD_KEY = 0x7FFFFFFF
# Extra quantization bits of |direction| per axis after the octant (the
# reference's default RTNW_KEY_DIRBITS).
DIR_BITS = 2

_EPS = 1e-20


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x two apart: b9..b0 -> b9 0 0 b8 ... b0."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| < 1e-20 replaced by +-1e-20 (sign of d, + at 0)."""
    small = torch.where(d >= 0.0, torch.full_like(d, _EPS),
                        torch.full_like(d, -_EPS))
    return 1.0 / torch.where(d.abs() < _EPS, small, d)


def ray_sort_key(origin: torch.Tensor, direction: torch.Tensor,
                 alive: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """int32 coherence key per ray (see the module docstring).

    origin, direction (N, 3); alive (N,) bool; lo, hi (3,) the root box:
    positions quantize to a 512^3 grid inside it (clipped outside). Bit 30
    marks rays whose slab test misses the root box.
    """
    span = torch.clamp_min(hi - lo, 1e-12)
    scale = torch.full_like(span, 512.0) / span

    def quant(a):
        g = (origin[:, a] - lo[a]) * scale[a]
        return torch.clamp(g, 0.0, 511.0).to(torch.int32)

    m = (_part1by2(quant(0)) << 2) | (_part1by2(quant(1)) << 1) | _part1by2(quant(2))
    neg = (direction < 0.0).to(torch.int32)
    octant = (neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]
    for a in range(3):
        q = torch.clamp((direction[:, a].abs() * float(1 << DIR_BITS))
                        .to(torch.int32), 0, (1 << DIR_BITS) - 1)
        octant = (octant << DIR_BITS) | q
    m = m >> (3 * DIR_BITS)
    rtn = rtf = None
    for a in range(3):
        inv = safe_inv(direction[:, a])
        t0 = (lo[a] - origin[:, a]) * inv
        t1 = (hi[a] - origin[:, a]) * inv
        tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
        rtn = tn if rtn is None else torch.maximum(rtn, tn)
        rtf = tf if rtf is None else torch.minimum(rtf, tf)
    miss_root = ((rtf < rtn) | (rtf < 0.0)).to(torch.int32)
    key = (miss_root << 30) | (octant << (27 - 3 * DIR_BITS)) | m
    key = torch.clamp_max(key, DEAD_KEY - 1)
    return torch.where(alive, key, torch.full_like(key, DEAD_KEY))


def unsort_radiance(slot: torch.Tensor, radiance: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Radiance (N, 3) back in wavefront order: row i goes to slot[i]."""
    out = torch.empty((n, 3), dtype=radiance.dtype, device=radiance.device)
    out[slot] = radiance
    return out


__all__ = ["DEAD_KEY", "DIR_BITS", "ray_sort_key", "safe_inv",
           "unsort_radiance"]
