"""Benchmarks (counterpart of raytracingthenextweekcuda_tpu/apps/bench.py):
the headline, Cornell box 512x512, 128 spp, 10 bounces, one pass
(`run_bench`), and the reference's three mesh metrics on the tile-BVH
path, each on the procedural stand-in of its scene
(apps/bench_scenes.py):

1. `run_mesh_bench`: the published mesh scene, 512x512, 32 spp, 10
   bounces, passes of 16 spp;
2. `run_mesh_stress`: the stress scene, the same configuration, with the
   work-list winner's leaf counters (`_winner_stats_probe`);
3. `run_mesh_large`: the large scene, 512x512, 8 spp, 5 bounces, one pass.

Each reports camera paths per second through `integrator.render` on one
CUDA device, the wall time of the timed render (host clock around the
render and a device synchronize), and the card's name and power limit as
nvidia-smi prints them.
"""

from __future__ import annotations

import subprocess
import time

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig


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


def _cuda_device(device):
    """`device` as a torch.device; a benchmark runs on a CUDA device only."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the benchmark needs a CUDA device, got {device}")
    return device


def run_bench(width: int = 512, height: int = 512, spp: int = 128,
              bounces: int = 10, spp_per_pass: int = 128, warmup: bool = True,
              device="cuda", keep_film: bool = False) -> dict:
    import torch

    from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    device = _cuda_device(device)
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


def _time_mesh_scene(scene, camera, cfg, asset: str, metric: str, use_bvh=True,
                     stats_probe: bool = False, device="cuda",
                     keep_film: bool = False) -> dict:
    """Finalize `scene` (`use_bvh` as `finalize` takes it: True forces the
    tile-BVH, None selects it above 256 triangles), render it at `cfg` once
    to warm up, then time one render through `integrator.render`, ended by
    a synchronize. With `stats_probe`, also the work-list winner's leaf
    counters over the first bounces (`_winner_stats_probe`)."""
    import torch

    from raytracingthenextweekcuda_tpu_torch.models import integrator
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.utils.timing import sync

    device = torch.device(device)
    triangles = int(scene.triangles.count)
    scene = finalize(scene, use_bvh=use_bvh)
    # Warm-up: builds and loads the kernels outside the timed region.
    sync(integrator.render(scene, camera, cfg, device=device).accum)
    t0 = time.perf_counter()
    film = integrator.render(scene, camera, cfg, device=device)
    sync(film.accum)
    dt = time.perf_counter() - t0
    leaf_bounds = scene.packed.leaf_bounds
    result = {
        "metric": metric,
        "paths_per_sec": cfg.num_pixels * cfg.spp / dt,
        "render_ms": dt * 1000.0,
        "triangles": triangles,
        "leaves": 0 if leaf_bounds is None else int(leaf_bounds.shape[1]),
        "asset": asset,
        "config": {"width": cfg.width, "height": cfg.height, "spp": cfg.spp,
                   "bounces": cfg.bounces, "spp_per_pass": cfg.spp_per_pass,
                   "sort_rays": cfg.sort_rays, "sort_stride": cfg.sort_stride},
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        "card": card_info(),
    }
    if stats_probe and leaf_bounds is not None:
        result["leaf_tile"] = int(scene.packed.trih.shape[1] // leaf_bounds.shape[1])
        result["stats"] = _winner_stats_probe(scene, camera, cfg, device=device)
    if keep_film:
        result["film"] = film
    return result


def run_mesh_bench(width: int = 512, height: int = 512, spp: int = 32,
                   bounces: int = 10, spp_per_pass: int = 16, device="cuda",
                   keep_film: bool = False) -> dict:
    """Mesh metric 1: the reference's published mesh benchmark configuration
    (raytracingthenextweekcuda_tpu/apps/bench.py:199-242), the router
    choosing the path (the tile-BVH above 256 triangles). The scene is the
    procedural stand-in of the published mesh scene, so no ratio to the
    reference's 2.17 M paths/s (taken on suzanne0.ply) is printed."""
    from raytracingthenextweekcuda_tpu_torch.apps.bench_scenes import (
        published_mesh_scene,
    )

    device = _cuda_device(device)
    scene, camera, asset = published_mesh_scene()
    cfg = RenderConfig(width=width, height=height, spp=spp, bounces=bounces,
                       spp_per_pass=spp_per_pass)
    return _time_mesh_scene(scene, camera, cfg, asset, "paths/s, tile-BVH mesh 512x512",
                            use_bvh=None, device=device, keep_film=keep_film)


def run_mesh_stress(width: int = 512, height: int = 512, spp: int = 32,
                    bounces: int = 10, spp_per_pass: int = 16, device="cuda",
                    keep_film: bool = False) -> dict:
    """Mesh metric 2: the reference's stress scene (cornellbox2 with the
    46,816-triangle materialball; here its 16,128-triangle stand-in) at the
    published configuration, through the tile-BVH, with the leaf counters
    of `_winner_stats_probe`."""
    from raytracingthenextweekcuda_tpu_torch.apps.bench_scenes import (
        stress_mesh_scene,
    )

    device = _cuda_device(device)
    scene, camera, asset = stress_mesh_scene()
    cfg = RenderConfig(width=width, height=height, spp=spp, bounces=bounces,
                       spp_per_pass=spp_per_pass)
    return _time_mesh_scene(scene, camera, cfg, asset,
                            "paths/s, tile-BVH stress mesh 512x512",
                            stats_probe=True, device=device, keep_film=keep_film)


def run_mesh_large(width: int = 512, height: int = 512, spp: int = 8,
                   bounces: int = 5, spp_per_pass: int = 8, device="cuda",
                   keep_film: bool = False) -> dict:
    """Mesh metric 3: the reference's large scene (about 562k triangles;
    here its 261,120-triangle stand-in) through the tile-BVH at 8 spp and 5
    bounces. In place of the reference's `streaming` flag, a decision of
    its TPU kernel, it records the leaf count and `frustum`, whether the
    packet-frustum work-list build ran (above 2048 leaves). No reference
    number exists at this scale: `vs_baseline` is null."""
    from raytracingthenextweekcuda_tpu_torch.apps.bench_scenes import (
        large_mesh_scene,
    )
    from raytracingthenextweekcuda_tpu_torch.ops.cuda.bvh_winner_kernel import (
        use_frustum_worklist,
    )

    device = _cuda_device(device)
    scene, camera, asset = large_mesh_scene()
    cfg = RenderConfig(width=width, height=height, spp=spp, bounces=bounces,
                       spp_per_pass=spp_per_pass)
    result = _time_mesh_scene(scene, camera, cfg, asset,
                              "paths/s, tile-BVH large mesh 512x512",
                              device=device, keep_film=keep_film)
    result["frustum"] = use_frustum_worklist(result["leaves"])
    result["vs_baseline"] = None
    return result


def _winner_stats_probe(scene, camera, cfg, bounces: int = 3,
                        device="cuda") -> dict:
    """The work-list winner's leaf counters over the first `bounces` of a
    1-sample wavefront (the reference's `_winner_stats_probe`,
    apps/bench.py:245-324): per bounce, the mean over the blocks with a
    non-empty list of its length (`listed`), of the positions walked before
    the horizon break (`walked`) and of the leaves evaluated (`evaluated`),
    and the number of such blocks (`live_blocks`).

    The loop is the reference's: primary rays of the key `key(seed)`,
    unsorted; from the second bounce on the wavefront sorted by the
    coherence key (argsort and gathers), its dead rays last; K3 without
    the mesh for each ray's ceiling; K4 with `stats`; `_bounce_body` to
    advance. As in the reference, throughput and the RNG context stay in
    the primary wavefront's slot order across the sort: the probe counts
    the winner's work and renders nothing."""
    import torch

    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models import integrator
    from raytracingthenextweekcuda_tpu_torch.ops import threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda.bvh_winner_kernel import (
        intersect_packed_bvh,
    )
    from raytracingthenextweekcuda_tpu_torch.ops.cuda.intersect_kernel import (
        BIG,
        intersect_packed,
    )
    from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene
    from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table
    from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import (
        DEAD_KEY,
        ray_sort_key,
    )

    device = torch.device(device)
    ds = device_scene(scene, device)
    mats = material_table(scene.materials, device)
    frame = cam.derive(camera, cfg.aspect_ratio)
    rays, ctx = cam.generate_rays(frame, threefry.key(cfg.seed), cfg.width,
                                  cfg.height, device=device)
    n = rays.count
    state = (rays, torch.ones((n, 3), device=device),
             torch.zeros((n, 3), device=device),
             torch.ones((n,), dtype=torch.bool, device=device))
    bounds = torch.from_numpy(scene.packed.bvh_bounds[:, 0].copy()).to(device)
    out = {}
    for b in range(bounces):
        rays_b, alive = state[0], state[3]
        if b > 0:  # the production path sorts from the second bounce on
            key = ray_sort_key(rays_b.origin, rays_b.direction, alive,
                               bounds[0:3], bounds[3:6])
            key, perm = torch.sort(key, stable=True)
            rays_b = rays_b.take(perm)
            alive = key != DEAD_KEY
        t_sel, code = intersect_packed(rays_b, ds.analytic, cfg.tmin, alive=alive)
        t_cap = torch.where(code >= 0, t_sel, torch.full_like(t_sel, BIG))
        _, _, (counts, st) = intersect_packed_bvh(rays_b, ds.leaves, cfg.tmin,
                                                  alive=alive, t_cap=t_cap,
                                                  stats=True)
        counts, st = counts.cpu().numpy(), st.cpu().numpy()
        nz = counts > 0
        out[f"bounce{b}"] = {
            "listed": round(float(counts[nz].mean()), 1) if nz.any() else 0,
            "walked": round(float(st[nz, 0].mean()), 1) if nz.any() else 0,
            "evaluated": round(float(st[nz, 1].mean()), 1) if nz.any() else 0,
            "live_blocks": int(nz.sum()),
        }
        if b + 1 < bounces:
            state = integrator._bounce_body(
                ds, mats, scene.packed.used_kinds, cfg,
                (rays_b, state[1], state[2], alive), ctx, b)
    return out
