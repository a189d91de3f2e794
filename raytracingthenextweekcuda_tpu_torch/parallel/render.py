"""Tile-sharded rendering (counterpart of
raytracingthenextweekcuda_tpu/parallel/render.py).

Each tile of the mesh (parallel/mesh.py) renders its contiguous slice of
the flattened pixels on its device; the scene goes to every device. The
RNG is a function of the global pixel id, the sample's key words and the
bounce, so a tile draws what the single-device render draws for its
pixels and the assembled image is the single-device render's, bit for bit:
nothing is communicated in the forward pass.
"""

from __future__ import annotations

import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as camera_mod
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models.film import Film
from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda.bounce_kernel import (
    device_or_raise,
    render_samples,
)
from raytracingthenextweekcuda_tpu_torch.parallel.mesh import TileMesh, tile_sharding


def _pass_local(scene, camera, key, cfg: RenderConfig, samples: int,
                pixels: slice, device) -> torch.Tensor:
    """The summed radiance (n, 3) of `samples` spp over the pixels of one
    tile, on `device`, routed as the reference's tile is
    (parallel/render.py:71-97): the render kernel K1 over the tile's pixel
    ids where a single-device pass would take it (fused, not sorted), else
    sample by sample, the tile's primary rays through `trace` (the sorted
    wavefront over K3 and K4 on tile-BVH scenes, K2 or the differentiable
    wavefront on the others)."""
    device = device_or_raise(device)
    pixel_ids = torch.arange(pixels.start, pixels.stop, dtype=torch.int64,
                             device=device)
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    sample_words = threefry.split(key, samples)
    if (integrator._fused_eligible(scene, cfg)
            and not integrator._sorted_eligible(scene)):
        return (render_samples(scene.packed, frame, sample_words, cfg,
                               pixel_ids=pixel_ids, device=device)
                + integrator._grad_probe(scene))
    target, mats = integrator._scene_on(scene, device)
    accum = torch.zeros((pixel_ids.numel(), 3), dtype=torch.float32, device=device)
    for words in sample_words:
        rays, ctx = camera_mod.generate_rays(frame, words, cfg.width, cfg.height,
                                             pixel_ids=pixel_ids, device=device)
        accum = accum + integrator._trace(scene, target, mats, rays, ctx, cfg)
    return accum


def render_pass_sharded(scene, camera, key, cfg: RenderConfig, samples: int,
                        mesh: TileMesh) -> torch.Tensor:
    """A pass of `samples` spp over the mesh's tiles: the summed radiance
    (H, W, 3), assembled on the mesh's first device in global pixel order.
    `cfg.num_pixels` must divide by the mesh size (ValueError)."""
    first = mesh.devices[0]
    tiles = [_pass_local(scene, camera, key, cfg, samples, pixels, device).to(first)
             for device, pixels in tile_sharding(mesh, cfg.num_pixels)]
    return torch.cat(tiles).reshape(cfg.height, cfg.width, 3)


def render_sharded(scene, camera, cfg: RenderConfig, mesh: TileMesh,
                   key=None) -> Film:
    """A whole sharded render: `cfg.passes()` accumulated into a Film on the
    mesh's first device, pass i keyed `fold_in(key, i)` as in
    `integrator.render`."""
    if key is None:
        key = threefry.key(cfg.seed)
    film = Film.create(cfg.width, cfg.height, device=device_or_raise(mesh.devices[0]))
    for i, chunk in enumerate(cfg.passes()):
        film = film.add(render_pass_sharded(scene, camera, threefry.fold_in(key, i),
                                            cfg, chunk, mesh), chunk)
    return film


__all__ = ["render_pass_sharded", "render_sharded"]
