"""Device meshes of tiles (counterpart of
raytracingthenextweekcuda_tpu/parallel/mesh.py).

One logical axis, `tiles`: the image's flattened pixels are split into
`mesh.size` contiguous tiles, one a device, and the scene is copied to
every device. A device may appear more than once: its tiles then run on
it one after another (several tiles on one card, or on the CPU in tests).
Only gradient reductions communicate (parallel/fit.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE_AXIS = "tiles"


class TileMesh(NamedTuple):
    """An ordered tuple of devices, one a tile."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> TileMesh:
    """A mesh of the first `n_devices` of `devices` (default: every
    visible CUDA device, and all of them when `n_devices` is None).
    Raises when fewer devices are given than asked for."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise ValueError(f"a mesh of {n_devices} devices asked for, "
                         f"{len(devices)} given")
    return TileMesh(tuple(devices[:n_devices]))


def tile_sharding(mesh: TileMesh, num_pixels: int) -> list[tuple[torch.device, slice]]:
    """Each tile's (device, slice of the flattened pixels): tile i holds
    pixels [i * n, (i + 1) * n), n = num_pixels / mesh.size."""
    if num_pixels % mesh.size:
        raise ValueError(f"num_pixels {num_pixels} not divisible by mesh size "
                         f"{mesh.size}")
    n = num_pixels // mesh.size
    return [(d, slice(i * n, (i + 1) * n)) for i, d in enumerate(mesh.devices)]


def replicated(mesh: TileMesh, tensor: torch.Tensor) -> dict:
    """`tensor`'s copy on each distinct device of the mesh, by device."""
    return {d: tensor.to(d) for d in dict.fromkeys(mesh.devices)}


__all__ = ["TILE_AXIS", "TileMesh", "make_mesh", "replicated", "tile_sharding"]
