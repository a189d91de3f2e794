"""Headline benchmark: Cornell box 512x512, 128 spp, 10 bounces, one pass
(counterpart of raytracingthenextweekcuda_tpu/apps/bench.py:18-114).

Reports camera paths per second through `integrator.render` on one CUDA
device, the wall time of the timed render (host clock around the render and
a device synchronize), and the card's name and power limit as nvidia-smi
prints them.
"""

from __future__ import annotations

import subprocess
import time


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not measured ({type(e).__name__})"
    return out.stdout.strip() or f"not measured (rc {out.returncode})"


def run_bench(width: int = 512, height: int = 512, spp: int = 128,
              bounces: int = 10, spp_per_pass: int = 128, warmup: bool = True,
              device="cuda", keep_film: bool = False) -> dict:
    import torch

    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the benchmark needs a CUDA device, got {device}")
    scene, camera = presets.cornell_box()
    scene = finalize(scene)  # 24 cube triangles: brute force, 2 boxes
    cfg = RenderConfig(width=width, height=height, spp=spp, bounces=bounces,
                       spp_per_pass=spp_per_pass)

    if warmup:  # builds and loads the kernel outside the timed region
        warm = RenderConfig(width=width, height=height,
                            spp=min(spp_per_pass, spp), bounces=bounces,
                            spp_per_pass=spp_per_pass)
        integrator.render(scene, camera, warm, device=device)
        torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    film = integrator.render(scene, camera, cfg, device=device)
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    paths = width * height * spp
    result = {
        "metric": "paths/s, Cornell box 512x512",
        "value": paths / dt,
        "unit": "paths/s",
        "render_ms": dt * 1000.0,
        "config": {"width": width, "height": height, "spp": spp,
                   "bounces": bounces, "spp_per_pass": spp_per_pass},
        "device": torch.cuda.get_device_name(device),
        "card": card_info(),
    }
    if keep_film:
        result["film"] = film
    return result
