"""Render passes and offline renders (counterpart of
raytracingthenextweekcuda_tpu/models/integrator.py:474-499, 597-605).

Only the whole-render route is ported: one launch of the render kernel per
pass (ops/cuda/bounce_kernel.render_samples). The key tree is the
reference's: `key(seed)`, `fold_in(key, pass)` per pass, `split(pass_key,
samples)` per sample, as host threefry words (ops/threefry.py).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as camera_mod
from raytracingthenextweekcuda_tpu_torch.models.film import Film
from raytracingthenextweekcuda_tpu_torch.models.scene import Scene
from raytracingthenextweekcuda_tpu_torch.ops import threefry


def check_eligible(scene: Scene, cfg: RenderConfig) -> None:
    """Raise for what the port cannot render yet."""
    if not cfg.fused_bounce:
        raise NotImplementedError(
            "fused_bounce=False (the differentiable wavefront engine): "
            "ROADMAP queue 1 item 7"
        )
    packed = scene.packed
    if packed is None or not getattr(packed, "shaded", False):
        raise NotImplementedError(
            "unpacked scene: call models.scene.finalize first (tile-BVH and "
            "LBVH scenes: ROADMAP queue 1 items 6-7)"
        )


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render on cuda requested but CUDA is not available")
    return device


def render_pass(scene: Scene, camera: camera_mod.Camera, key: np.ndarray,
                cfg: RenderConfig, samples: int, device="cpu") -> torch.Tensor:
    """Trace `samples` spp and return the summed radiance (H, W, 3) on
    `device`."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda.bounce_kernel import (
        render_samples,
    )

    check_eligible(scene, cfg)
    device = _device(device)
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    sample_words = threefry.split(key, samples)
    accum = render_samples(scene.packed, frame, sample_words, cfg,
                           device=device)
    return accum.reshape(cfg.height, cfg.width, 3)


def render(scene: Scene, camera: camera_mod.Camera, cfg: RenderConfig,
           key: np.ndarray | None = None, device="cpu") -> Film:
    """Full offline render: accumulate cfg.spp over passes into a Film."""
    check_eligible(scene, cfg)
    device = _device(device)
    if key is None:
        key = threefry.key(cfg.seed)
    film = Film.create(cfg.width, cfg.height, device=device)
    for i, chunk in enumerate(cfg.passes()):
        pass_key = threefry.fold_in(key, i)
        film = film.add(render_pass(scene, camera, pass_key, cfg, chunk,
                                    device=device), chunk)
    return film
