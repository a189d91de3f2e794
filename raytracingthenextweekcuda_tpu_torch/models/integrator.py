"""Render passes and offline renders (counterpart of
raytracingthenextweekcuda_tpu/models/integrator.py).

Two engines, chosen by the scene as the reference chooses them:

- Scenes without a tile-BVH render each pass in one launch of the render
  kernel K1 (ops/cuda/bounce_kernel.render_samples).
- Tile-BVH scenes (meshes above 256 triangles, models/scene.finalize)
  render through the sorted wavefront (`_trace_sorted`): all of a pass's
  samples form one wavefront of samples x pixels rays (capped at 4M rays
  and 64 samples), and each bounce is `_bounce_body` in torch around the
  kernels K3 (analytic closest hit) and K4 (tile-BVH winner). From the
  second bounce on, the wavefront is first sorted by a coherence key
  (ops/wavefront_sort.py) every `sort_stride` bounces, and the rays that
  died sort to the tail and leave the wavefront; at the end the radiance
  goes back to pixel order. `sort_rays=False` keeps the same engine on the
  unsorted wavefront. Every random draw is a function of (pixel, sample
  key, bounce), so sorting does not change the image.

The key tree is the reference's: `key(seed)`, `fold_in(key, pass)` per
pass, `split(pass_key, samples)` per sample, as host threefry words
(ops/threefry.py).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as camera_mod
from raytracingthenextweekcuda_tpu_torch.models.film import Film
from raytracingthenextweekcuda_tpu_torch.models.scene import Scene
from raytracingthenextweekcuda_tpu_torch.ops import linalg, rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.fused import (
    DeviceScene,
    device_scene,
    intersect_scene_fused,
)
from raytracingthenextweekcuda_tpu_torch.ops.materials import (
    MaterialRows,
    gather,
    material_table,
    scatter,
)
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays
from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import (
    DEAD_KEY,
    ray_sort_key,
    unsort_radiance,
)

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)

# Sorted wavefronts hold at most this many rays and samples.
_SORT_WAVEFRONT_CAP = 4 * 1024 * 1024
_SORT_SAMPLE_GROUP_CAP = 64


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
            "unpacked scene: call models.scene.finalize first (LBVH "
            "scenes: ROADMAP queue 1 item 7)"
        )


def _sorted_eligible(scene: Scene) -> bool:
    """Tile-BVH scenes render through the sorted wavefront."""
    return scene.packed.leaf_bounds is not None


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render on cuda requested but CUDA is not available")
    return device


def sky_color(direction: torch.Tensor) -> torch.Tensor:
    """Sky gradient on the unit direction."""
    unit = linalg.normalize(direction)
    t = 0.5 * (unit[:, 1] + 1.0)
    white = torch.tensor(SKY_WHITE, dtype=torch.float32, device=direction.device)
    blue = torch.tensor(SKY_BLUE, dtype=torch.float32, device=direction.device)
    return linalg.lerp(white, blue, t[:, None])


def _bounce_body(ds: DeviceScene, mats: MaterialRows, used_kinds,
                 cfg: RenderConfig, state, ctx: rng.RayCtx, bounce_idx: int):
    """One wavefront bounce: intersect, gather, scatter, bookkeeping.

    `state` = (rays, throughput (N, 3), radiance (N, 3), alive (N,) bool);
    returns the advanced state. Every operation is row-independent, so any
    order of the rays gives the same rows.
    """
    rays, throughput, radiance, alive = state
    hit = intersect_scene_fused(ds, rays, cfg.tmin, alive=alive)
    mat = gather(mats, hit.material_id)
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, bounce_idx)
    scat = scatter(u4, rays, hit, mat, used_kinds)
    if cfg.sky_background:
        sky = sky_color(rays.direction)
    else:
        sky = torch.zeros_like(rays.direction)
    zero = torch.zeros_like(radiance)
    miss = alive & ~hit.valid
    terminal = alive & hit.valid & ~scat.scattered
    radiance = radiance + torch.where(miss[:, None], throughput * sky, zero)
    radiance = radiance + torch.where(terminal[:, None],
                                      throughput * scat.emitted, zero)
    # Path B additive emission: every hit releases it and the path goes on.
    radiance = radiance + torch.where((alive & hit.valid)[:, None],
                                      throughput * mat.emission, zero)
    cont = alive & hit.valid & scat.scattered
    new_tp = torch.where(cont[:, None], throughput * scat.attenuation, throughput)
    if cfg.russian_roulette:
        p = torch.clamp(new_tp.amax(dim=1), 0.05, 1.0)
        do_rr = bounce_idx >= cfg.rr_start_bounce
        survive = (u4[:, 3] < p) if do_rr else torch.ones_like(cont)
        if do_rr:
            new_tp = torch.where((cont & survive)[:, None], new_tp / p[:, None],
                                 new_tp)
        cont = cont & survive
    safe_t = torch.where(hit.valid, hit.t, torch.zeros_like(hit.t))
    new_rays = Rays(
        origin=torch.where(cont[:, None], rays.at(safe_t), rays.origin),
        direction=torch.where(cont[:, None], scat.direction, rays.direction),
        time=rays.time,
    )
    return new_rays, new_tp, radiance, cont


def _trace_sorted(scene: Scene, ds: DeviceScene, rays: Rays,
                  sample_words, cfg: RenderConfig) -> torch.Tensor:
    """Trace a multi-sample wavefront (ray s*num_pixels + p is sample s at
    pixel p) to the end; returns its radiance (N, 3) in wavefront order."""
    dev = rays.origin.device
    n = rays.count
    n_pix = cfg.num_pixels
    tb0, tb1 = rng.key_bases(sample_words, dev)
    mats = material_table(scene.materials, dev)
    used_kinds = scene.packed.used_kinds
    bounds = torch.from_numpy(scene.packed.bvh_bounds[:, 0].copy()).to(dev)
    lo, hi = bounds[0:3], bounds[3:6]

    def ctx_of(slot):
        sid = torch.div(slot, n_pix, rounding_mode="floor")
        return rng.RayCtx(slot % n_pix, tb0[sid], tb1[sid])

    slot = torch.arange(n, dtype=torch.int64, device=dev)
    state = (rays, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev))
    done_slots, done_rad = [], []  # rays that left the wavefront
    stride = max(1, int(cfg.sort_stride))
    for b in range(cfg.bounces):
        if b > 0 and cfg.sort_rays and (b - 1) % stride == 0:
            rays_b, tp, rad, alive = state
            key = ray_sort_key(rays_b.origin, rays_b.direction, alive, lo, hi)
            key, perm = torch.sort(key, stable=True)
            n_live = int((key != DEAD_KEY).sum())
            dead, keep = perm[n_live:], perm[:n_live]
            done_slots.append(slot[dead])
            done_rad.append(rad[dead])
            slot = slot[keep]
            state = (rays_b.take(keep), tp[keep], rad[keep], alive[keep])
        elif b > 0:
            n_live = int(state[3].any())
        else:
            n_live = n
        if n_live == 0:  # whole-wavefront early-out
            break
        state = _bounce_body(ds, mats, used_kinds, cfg, state, ctx_of(slot), b)
    done_slots.append(slot)
    done_rad.append(state[2])
    return unsort_radiance(torch.cat(done_slots), torch.cat(done_rad), n)


def _render_pass_sorted(scene: Scene, frame, sample_words,
                        cfg: RenderConfig, device) -> torch.Tensor:
    n = cfg.num_pixels
    samples = sample_words.shape[0]
    group = max(1, min(samples, _SORT_WAVEFRONT_CAP // max(n, 1),
                       _SORT_SAMPLE_GROUP_CAP))
    ds = device_scene(scene, device)
    accum = torch.zeros((n, 3), dtype=torch.float32, device=device)
    for start in range(0, samples, group):
        words = sample_words[start: start + group]
        rays, _ = camera_mod.generate_rays_multi(frame, words, cfg.width,
                                                 cfg.height, device)
        radiance = _trace_sorted(scene, ds, rays, words, cfg)
        for s in range(words.shape[0]):
            accum = accum + radiance[s * n: (s + 1) * n]
    return accum


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
    if _sorted_eligible(scene):
        accum = _render_pass_sorted(scene, frame, sample_words, cfg, device)
    else:
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
