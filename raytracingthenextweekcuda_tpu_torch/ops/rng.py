"""Counter-based per-ray RNG: the pcg4d hash on (pixel, key word, counter,
key word), counterpart of raytracingthenextweekcuda_tpu/ops/rng.py.

torch has little uint32 arithmetic, so the words ride in int64 tensors
holding values in [0, 2**32): every multiply and add is masked back to 32
bits, and the low 32 bits of an int64 product survive its wraparound, so the
results are bit-equal to uint32 arithmetic. The CUDA kernel uses uint32_t.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Counter domains: bounce b uses counter b + 1; raygen uses these two.
RAYGEN_DOMAIN = 0x9E3779B9
RAYGEN_DOMAIN2 = 0x85EBCA6B

_MASK = 0xFFFFFFFF
_U24_INV = 1.0 / 16777216.0  # 2^-24, exact


class RayCtx(NamedTuple):
    """Per-ray RNG context: the pixel id and the two uint32 key words of
    the ray's sample, as int64 tensors of uint32 values (the words are
    Python ints when every ray shares one sample)."""

    pixel_id: torch.Tensor
    base0: torch.Tensor | int
    base1: torch.Tensor | int


class SlotCtx(NamedTuple):
    """The RayCtx of a sorted wavefront's slots, as tables: slot s holds
    pixel `pixel[s % n]` (s % n where `pixel` is None) of the sample whose
    key words are `base0[s // m]` and `base1[s // m]`, (S,) int64 tensors of
    uint32 values. The shade kernel reads the same tables."""

    pixel: torch.Tensor | None
    base0: torch.Tensor
    base1: torch.Tensor
    n: int
    m: int

    def at(self, slot: torch.Tensor) -> RayCtx:
        """The RayCtx of the rays at wavefront slots `slot`."""
        pid = slot % self.n
        if self.pixel is not None:
            pid = self.pixel[pid]
        sid = torch.div(slot, self.m, rounding_mode="floor")
        return RayCtx(pid, self.base0[sid], self.base1[sid])


def key_bases(sample_words, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The two words of each sample's key, from the (S, 2) uint32 key words
    of ops/threefry.split, as (S,) int64 tensors."""
    w = np.asarray(sample_words, np.uint32).reshape(-1, 2).astype(np.int64)
    return (torch.from_numpy(w[:, 0].copy()).to(device),
            torch.from_numpy(w[:, 1].copy()).to(device))


def _words(x, device=None) -> torch.Tensor:
    """int64 tensor of uint32 words from an int, numpy array or tensor."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def _device(*xs):
    return next((x.device for x in xs if torch.is_tensor(x)), None)


def _mix(a, b, c, d):
    a = (a + b * d) & _MASK
    b = (b + c * a) & _MASK
    c = (c + a * b) & _MASK
    d = (d + b * c) & _MASK
    return a, b, c, d


def pcg4d(a, b, c, d):
    """pcg4d hash: 4 uint32 word tensors in (int64), 4 uint32 words out."""
    dev = _device(a, b, c, d)
    a, b, c, d = torch.broadcast_tensors(*(_words(v, dev) for v in (a, b, c, d)))
    a, b, c, d = ((v * 1664525 + 1013904223) & _MASK for v in (a, b, c, d))
    a, b, c, d = _mix(a, b, c, d)
    a, b, c, d = (v ^ (v >> 16) for v in (a, b, c, d))
    return _mix(a, b, c, d)


def to_uniform(u: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1): top 24 bits (via int32) x 2^-24."""
    return (_words(u) >> 8).to(torch.int32).to(torch.float32) * _U24_INV


def uniforms4(pixel_id, base0, base1, counter) -> torch.Tensor:
    """(N, 4) uniforms for a scalar or (N,) counter."""
    a, b, c, d = pcg4d(pixel_id, base0, counter, base1)
    return torch.stack([to_uniform(a), to_uniform(b), to_uniform(c),
                        to_uniform(d)], dim=-1)


def bounce_uniforms(pixel_id, base0, base1, bounce_idx) -> torch.Tensor:
    """(N, 4) uniforms of bounce `bounce_idx` (0-based): counter = bounce+1.
    Slots 0-2 feed the BSDF, slot 3 Russian roulette."""
    return uniforms4(pixel_id, base0, base1, (int(bounce_idx) + 1) & _MASK)


def shutter_uniform(pixel_id, base0, base1) -> torch.Tensor:
    """(N,) shutter-time uniform (raygen slot 4)."""
    t, _, _, _ = pcg4d(pixel_id, base0, RAYGEN_DOMAIN2, base1)
    return to_uniform(t)


def raygen_uniforms(pixel_id, base0, base1) -> torch.Tensor:
    """(N, 5) raygen uniforms: pixel jitter (2), lens disk (2), shutter (1)."""
    u4 = uniforms4(pixel_id, base0, base1, RAYGEN_DOMAIN)
    return torch.cat([u4, shutter_uniform(pixel_id, base0, base1)[..., None]],
                     dim=-1)


__all__ = [
    "RayCtx", "SlotCtx", "key_bases", "pcg4d", "to_uniform", "uniforms4", "bounce_uniforms", "raygen_uniforms",
    "shutter_uniform", "RAYGEN_DOMAIN", "RAYGEN_DOMAIN2",
]
