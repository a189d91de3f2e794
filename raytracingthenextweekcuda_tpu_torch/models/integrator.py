"""Render passes, G-buffer renders and offline renders (counterpart of
raytracingthenextweekcuda_tpu/models/integrator.py).

`trace` routes a wavefront of one sample as the reference routes it:

- Tile-BVH scenes (meshes above 256 triangles, models/scene.finalize)
  trace through the sorted wavefront (`_trace_sorted`): each bounce runs
  the kernels K3 (analytic closest hit) and K4 (tile-BVH winner), then
  one launch of the shade kernel (ops/cuda/shade_kernel.py: the merge,
  the recompute, the BSDF and the bookkeeping) on a CUDA state whose
  tables need no gradient, else its plain version, the torch body that
  `_bounce_body` runs after its closest hit. From the second bounce on,
  the wavefront is first sorted by a coherence key
  (ops/wavefront_sort.py) every `sort_stride` bounces, and the rays that
  died sort to the tail and leave the wavefront; at the end the radiance
  goes back to ray order.
  `sort_rays=False` keeps the same engine on the unsorted wavefront.
- Other finalized scenes with `cfg.fused_bounce` trace in one launch of
  the path kernel K2 (ops/cuda/bounce_kernel.path_trace), forward only.
- Everything else runs the differentiable wavefront: `_bounce_body` per
  bounce, over K3 and the torch recompute for finalized scenes, or over
  the plain torch intersects (ops/intersect.py) for unfinalized ones, with
  a whole-wavefront early-out once every ray has died. Gradients flow
  through the recompute and the BSDF into the scene's tensor leaves.
  A scene with an LBVH (`scene.bvh`, ops/bvh.py) takes this engine too:
  the LBVH walk (ops/traverse.py) finds its triangles' hits, beside K3
  or the plain intersects, and the vertex gradients flow through it.

Tile-BVH scenes without an LBVH take the sorted wavefront before the
bounce kernels, as in the reference; with `_sorted_eligible` made false
(the reference's cross-engine check) they take K1 and K2, whose tile-BVH
walk then finds the mesh hits.

`render_pass` renders a pass in one launch of the render kernel K1 where
`trace` would take K2, through one multi-sample sorted wavefront (all of
a pass's samples as samples x pixels rays, capped at 4M rays and 64
samples) for tile-BVH scenes, and sample by sample through `trace`
otherwise. `render_gbuffer` adds the primary hit's depth, normal, albedo
and mask. Every random draw is a function of (pixel, sample key, bounce),
so neither the engine nor the sort changes the image. The forward-only
kernels carry `_grad_probe`: a backward through them raises.

The key tree is the reference's: `key(seed)`, `fold_in(key, pass)` per
pass, `split(pass_key, samples)` per sample, as host threefry words
(ops/threefry.py).

The layers of a render lie in spans (utils/timing.span) that a running
torch.profiler records: `integrator.render` an image, `integrator.prep` a
pass, and on the sorted wavefront `wavefront.prep`, `wavefront.sort`,
`wavefront.bounce` (with `wavefront.shade` around the shade kernel's
launch) and `wavefront.unsort`; `host.read` marks each read of
a device value. Without a profiler they cost one check each.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import INFINITY, RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as camera_mod
from raytracingthenextweekcuda_tpu_torch.models.film import Film
from raytracingthenextweekcuda_tpu_torch.models.scene import Scene
from raytracingthenextweekcuda_tpu_torch.ops import (
    geometry as geom,
    intersect,
    linalg,
    rng,
    threefry,
    traverse,
)
from raytracingthenextweekcuda_tpu_torch.ops.bvh import BVH
from raytracingthenextweekcuda_tpu_torch.ops.cuda import shade_kernel
from raytracingthenextweekcuda_tpu_torch.ops.cuda.bounce_kernel import (
    path_trace,
    render_samples,
)
from raytracingthenextweekcuda_tpu_torch.ops.cuda.launch import (
    device_or_raise,
    grad_probe,
)
from raytracingthenextweekcuda_tpu_torch.ops.fused import (
    DeviceScene,
    device_scene,
    intersect_scene_fused,
    winners,
)
from raytracingthenextweekcuda_tpu_torch.ops.geometry import Triangles
from raytracingthenextweekcuda_tpu_torch.ops.intersect import leaf
from raytracingthenextweekcuda_tpu_torch.ops.materials import (
    MaterialRows,
    gather,
    material_table,
    scatter,
)
from raytracingthenextweekcuda_tpu_torch.ops.rays import Hit, Rays, closer
from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import (
    DEAD_KEY,
    ray_sort_key,
    unsort_radiance,
)
from raytracingthenextweekcuda_tpu_torch.utils.timing import span

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)

# Sorted wavefronts hold at most this many rays and samples.
_SORT_WAVEFRONT_CAP = 4 * 1024 * 1024
_SORT_SAMPLE_GROUP_CAP = 64


def _sorted_eligible(scene: Scene) -> bool:
    """Tile-BVH scenes without an LBVH trace through the sorted wavefront
    (reference integrator.py:168-192). It takes precedence over the bounce
    kernels, whose tile-BVH walk serves as the other engine of the
    cross-engine check (force it by making this test false)."""
    return (scene.packed is not None and getattr(scene.packed, "shaded", False)
            and scene.packed.leaf_bounds is not None and scene.bvh is None)


def _fused_eligible(scene: Scene, cfg: RenderConfig) -> bool:
    """The bounce kernels cover the whole scene (reference
    integrator.py:158-165): a shaded pack and no LBVH."""
    return (cfg.fused_bounce and scene.packed is not None
            and getattr(scene.packed, "shaded", False) and scene.bvh is None)


def sky_color(direction: torch.Tensor) -> torch.Tensor:
    """Sky gradient on the unit direction."""
    unit = linalg.normalize(direction)
    t = 0.5 * (unit[:, 1] + 1.0)
    white = torch.tensor(SKY_WHITE, dtype=torch.float32, device=direction.device)
    blue = torch.tensor(SKY_BLUE, dtype=torch.float32, device=direction.device)
    return linalg.lerp(white, blue, t[:, None])


def _grad_probe(scene: Scene):
    """Exactly 0 in the forward, but carrying every scene leaf that
    requires grad into `ForwardOnly`, whose backward raises: the kernels'
    outputs carry no graph, so a backward through a fused render would
    otherwise give zero gradients silently."""
    return grad_probe(*(getattr(part, f.name)
                        for part in (scene.spheres, scene.planes,
                                     scene.triangles, scene.materials)
                        for f in dataclasses.fields(part)))


def intersect_scene(scene: Scene, rays: Rays, tmin, tmax=INFINITY,
                    alive=None) -> Hit:
    """Closest hit over the whole scene, in three regimes: a finalized
    scene goes to K3 (and K4 on a tile-BVH) with the torch recompute
    (ops/fused.py); an unfinalized one to the plain torch intersects
    (ops/intersect.py), which honour `tmax`. A scene with an LBVH
    (`scene.bvh`) adds the LBVH walk over `scene.triangles`
    (ops/traverse.py) to either, the reference's two-level dispatch."""
    return _closest_hit(_scene_on(scene, rays.origin.device)[0], rays, tmin,
                        tmax, alive)


class LbvhTarget(NamedTuple):
    """What the wavefront reads of a scene with an LBVH on one device: the
    target of its other primitives (a DeviceScene, or the unfinalized
    scene without its triangles), and the triangles and LBVH that
    `traverse.intersect_bvh` walks."""

    base: object
    triangles: Triangles
    bvh: BVH


# Scenes placed on a device: id(scene) -> (a weak reference to the scene,
# {device: what `_place` made}). An entry leaves with its scene.
_PLACED: dict[int, tuple] = {}


def _scene_on(scene: Scene, device):
    """What the torch wavefront reads on `device`: the DeviceScene of a
    finalized scene, or the unfinalized scene itself, inside an
    LbvhTarget when the scene has an LBVH; and the material table.

    A finalized scene whose leaves are all numpy arrays, as `SceneBuilder`
    and `finalize` make them, is placed once a device and kept while the
    scene lives, so a render does not rebuild and upload its DeviceScene
    every pass. A scene with tensor leaves (`with_leaves`, the
    differentiable engine) is placed anew on every call, so the recompute
    reads its current values and autograd graph; so is an unfinalized
    scene, which is its own target."""
    if scene.packed is None or any(
            isinstance(getattr(part, f.name), torch.Tensor)
            for part in (scene.spheres, scene.planes, scene.triangles,
                         scene.materials)
            for f in dataclasses.fields(part)):
        return _place(scene, device)
    key = id(scene)
    ref, placed = _PLACED.get(key, (None, None))
    if ref is None or ref() is not scene:
        def forget(dead, key=key):
            if _PLACED.get(key, (None,))[0] is dead:
                del _PLACED[key]

        ref, placed = weakref.ref(scene, forget), {}
        _PLACED[key] = (ref, placed)
    device = torch.device(device)
    if device not in placed:
        placed[device] = _place(scene, device)
    return placed[device]


def _place(scene: Scene, device):
    """`_scene_on`'s target and material table, made anew."""
    target = device_scene(scene, device) if scene.packed is not None else scene
    if scene.bvh is not None and scene.triangles.count:
        tri = scene.triangles
        if scene.packed is None:  # the LBVH walk takes the triangles' place
            target = dataclasses.replace(scene, triangles=geom.empty_triangles())
        target = LbvhTarget(target, Triangles(
            leaf(tri.vertices, device).reshape(-1, 3, 3),
            leaf(tri.material_id, device, torch.int64), tri.mesh_id),
            scene.bvh.to(device))
    return target, material_table(scene.materials, device)


def _closest_hit(target, rays: Rays, tmin, tmax=INFINITY, alive=None) -> Hit:
    """`intersect_scene` on a target of `_scene_on`. The unfinalized
    regime tests every ray; the bookkeeping masks the dead ones."""
    if isinstance(target, LbvhTarget):
        return closer(_closest_hit(target.base, rays, tmin, tmax, alive),
                      traverse.intersect_bvh(rays, target.triangles, target.bvh,
                                             tmin, tmax, alive=alive))
    if isinstance(target, DeviceScene):
        return intersect_scene_fused(target, rays, tmin, alive=alive)
    hit = Hit.none(rays.count, rays.origin.device)
    if target.spheres.count:
        hit = closer(hit, intersect.intersect_spheres(rays, target.spheres, tmin, tmax))
    if target.planes.count:
        hit = closer(hit, intersect.intersect_planes(rays, target.planes, tmin, tmax))
    if target.triangles.count:
        hit = closer(hit, intersect.intersect_triangles(rays, target.triangles,
                                                        tmin, tmax))
    return hit


def _bounce_body(ds, mats: MaterialRows, used_kinds,
                 cfg: RenderConfig, state, ctx: rng.RayCtx, bounce_idx: int):
    """One wavefront bounce: intersect, gather, scatter, bookkeeping.

    `ds` is a target of `_scene_on` (a DeviceScene, or an unfinalized
    scene); `state` = (rays, throughput (N, 3), radiance (N, 3), alive (N,)
    bool); returns the advanced state. Every operation is row-independent,
    so any order of the rays gives the same rows.
    """
    hit = _closest_hit(ds, state[0], cfg.tmin, alive=state[3])
    return _shade(mats, used_kinds, cfg, state, hit, ctx, bounce_idx)


def _shade(mats: MaterialRows, used_kinds, cfg: RenderConfig, state, hit: Hit,
           ctx: rng.RayCtx, bounce_idx: int):
    """The bounce after the closest hit `hit`: gather, scatter,
    bookkeeping. The shade kernel's plain version ends with it
    (ops/cuda/shade_kernel.py)."""
    rays, throughput, radiance, alive = state
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
        p = torch.clamp(new_tp.amax(dim=1), 0.05, 1.0).detach()
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


def _kernel_shades(ds: DeviceScene, mats: MaterialRows, state) -> bool:
    """Whether the shade kernel takes a sorted bounce: on a CUDA state
    whose graph nothing asks for. Where grad mode is on and a recompute
    table, a material row or the state requires grad, the torch body runs
    and carries the gradient (apps/fit.run_fit_mesh trains through it)."""
    rays, throughput, radiance, _ = state
    if rays.origin.device.type != "cuda":
        return False
    return not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (ds.spheres, ds.planes, ds.triangles,
                                  mats.albedo, mats.param, mats.emission,
                                  rays.origin, rays.direction, rays.time,
                                  throughput, radiance)))


def _sorted_bounce(ds: DeviceScene, mats: MaterialRows, used_kinds,
                   cfg: RenderConfig, state, ctx: rng.SlotCtx, slot,
                   bounce_idx: int):
    """One bounce of the sorted wavefront: K3 and K4 find the winners, then
    one launch of the shade kernel does the rest where `_kernel_shades`,
    else its plain version, the torch body."""
    win = winners(ds, state[0], cfg.tmin, alive=state[3])
    if _kernel_shades(ds, mats, state):
        with span("wavefront.shade"):
            return shade_kernel.shade(ds, mats, used_kinds, cfg, state, win, ctx,
                                      slot, bounce_idx)
    return shade_kernel.shade_reference(ds, mats, used_kinds, cfg, state, win, ctx,
                                        slot, bounce_idx)


def _trace_sorted(scene: Scene, ds: DeviceScene, mats: MaterialRows,
                  rays: Rays, cfg: RenderConfig, ctx: rng.SlotCtx) -> torch.Tensor:
    """Trace a wavefront on a tile-BVH scene to the end; returns its
    radiance (N, 3) in wavefront order. `ctx` gives the RayCtx of each
    wavefront slot."""
    dev = rays.origin.device
    n = rays.count
    used_kinds = scene.packed.used_kinds
    bounds = torch.from_numpy(scene.packed.bvh_bounds[:, 0].copy()).to(dev)
    lo, hi = bounds[0:3], bounds[3:6]

    slot = torch.arange(n, dtype=torch.int64, device=dev)
    state = (rays, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev))
    done_slots, done_rad = [], []  # rays that left the wavefront
    stride = max(1, int(cfg.sort_stride))
    for b in range(cfg.bounces):
        if b > 0 and cfg.sort_rays and (b - 1) % stride == 0:
            with span("wavefront.sort"):
                rays_b, tp, rad, alive = state
                key = ray_sort_key(rays_b.origin.detach(),
                                   rays_b.direction.detach(), alive, lo, hi)
                key, perm = torch.sort(key, stable=True)
                with span("host.read"):
                    n_live = int((key != DEAD_KEY).sum())
                dead, keep = perm[n_live:], perm[:n_live]
                done_slots.append(slot[dead])
                done_rad.append(rad[dead])
                slot = slot[keep]
                state = (rays_b.take(keep), tp[keep], rad[keep], alive[keep])
        elif b > 0:
            with span("host.read"):
                n_live = int(state[3].any())
        else:
            n_live = n
        if n_live == 0:  # whole-wavefront early-out
            break
        with span("wavefront.bounce"):
            state = _sorted_bounce(ds, mats, used_kinds, cfg, state, ctx, slot, b)
    with span("wavefront.unsort"):
        done_slots.append(slot)
        done_rad.append(state[2])
        return unsort_radiance(torch.cat(done_slots), torch.cat(done_rad), n)


def _trace_wavefront(target, mats: MaterialRows, used_kinds, rays: Rays,
                     ctx: rng.RayCtx, cfg: RenderConfig) -> torch.Tensor:
    """The differentiable wavefront: every ray through every bounce in ray
    order, until every ray has died."""
    n = rays.count
    dev = rays.origin.device
    state = (rays, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev))
    for b in range(cfg.bounces):
        if b > 0:
            with span("host.read"):
                live = bool(state[3].any())
            if not live:  # whole-wavefront early-out
                break
        state = _bounce_body(target, mats, used_kinds, cfg, state, ctx, b)
    return state[2]


def _trace_fused(scene: Scene, rays: Rays, ctx: rng.RayCtx,
                 cfg: RenderConfig) -> torch.Tensor:
    """The whole bounce loop of the wavefront in one launch of K2; forward
    only."""
    return path_trace(scene.packed, rays, ctx, cfg) + _grad_probe(scene)


def _slot_ctx(ctx: rng.RayCtx) -> rng.SlotCtx:
    """The SlotCtx of a wavefront in ray order: slot s is ray s, with key
    words per ray, or one pair for every ray."""
    pid = ctx.pixel_id.to(torch.int64).contiguous()
    n = max(1, pid.shape[0])
    words = [torch.as_tensor(w, dtype=torch.int64, device=pid.device).reshape(-1)
             for w in (ctx.base0, ctx.base1)]
    per_ray = any(torch.is_tensor(w) and w.dim() for w in (ctx.base0, ctx.base1))
    if per_ray:
        words = [w.expand(pid.shape[0]).contiguous() for w in words]
    return rng.SlotCtx(pid, *words, n, 1 if per_ray else n)


def _trace(scene: Scene, target, mats: MaterialRows, rays: Rays,
           ctx: rng.RayCtx, cfg: RenderConfig) -> torch.Tensor:
    """`trace` on the target and material table of `_scene_on`."""
    if _sorted_eligible(scene):
        return _trace_sorted(scene, target, mats, rays, cfg, _slot_ctx(ctx))
    if _fused_eligible(scene, cfg):
        return _trace_fused(scene, rays, ctx, cfg)
    used_kinds = scene.packed.used_kinds if scene.packed is not None else None
    return _trace_wavefront(target, mats, used_kinds, rays, ctx, cfg)


def trace(scene: Scene, rays: Rays, ctx: rng.RayCtx, cfg: RenderConfig) -> torch.Tensor:
    """Path-trace a wavefront to the end: radiance (N, 3), on the rays'
    device. `ctx` is the rays' RayCtx (models/camera.generate_rays); every
    random draw is a function of (pixel, key words, bounce)."""
    target, mats = _scene_on(scene, rays.origin.device)
    return _trace(scene, target, mats, rays, ctx, cfg)


def _render_pass_sorted(scene: Scene, frame, sample_words,
                        cfg: RenderConfig, device) -> torch.Tensor:
    n = cfg.num_pixels
    samples = sample_words.shape[0]
    group = max(1, min(samples, _SORT_WAVEFRONT_CAP // max(n, 1),
                       _SORT_SAMPLE_GROUP_CAP))
    with span("wavefront.prep"):
        ds, mats = _scene_on(scene, device)
    accum = torch.zeros((n, 3), dtype=torch.float32, device=device)
    for start in range(0, samples, group):
        words = sample_words[start: start + group]
        with span("wavefront.prep"):
            rays, _ = camera_mod.generate_rays_multi(frame, words, cfg.width,
                                                     cfg.height, device)
            tb0, tb1 = rng.key_bases(words, device)

        radiance = _trace_sorted(scene, ds, mats, rays, cfg,
                                 rng.SlotCtx(None, tb0, tb1, n, n))
        for s in range(words.shape[0]):
            accum = accum + radiance[s * n: (s + 1) * n]
    return accum


def render_pass(scene: Scene, camera: camera_mod.Camera, key: np.ndarray,
                cfg: RenderConfig, samples: int, device="cuda") -> torch.Tensor:
    """Trace `samples` spp and return the summed radiance (H, W, 3) on
    `device`."""
    device = device_or_raise(device)
    with span("integrator.prep"):
        frame = camera_mod.derive(camera, cfg.aspect_ratio)
        sample_words = threefry.split(key, samples)
    if _sorted_eligible(scene):
        accum = _render_pass_sorted(scene, frame, sample_words, cfg, device)
    elif _fused_eligible(scene, cfg):
        accum = render_samples(scene.packed, frame, sample_words, cfg,
                               device=device) + _grad_probe(scene)
    else:
        target, mats = _scene_on(scene, device)
        accum = torch.zeros((cfg.num_pixels, 3), dtype=torch.float32,
                            device=device)
        for words in sample_words:
            rays, ctx = camera_mod.generate_rays(frame, words, cfg.width,
                                                 cfg.height, device=device)
            accum = accum + _trace(scene, target, mats, rays, ctx, cfg)
    return accum.reshape(cfg.height, cfg.width, 3)


def render_gbuffer(scene: Scene, camera: camera_mod.Camera, key: np.ndarray,
                   cfg: RenderConfig, samples: int, device="cuda") -> dict:
    """Radiance and the primary hit's AOVs, on `device`.

    Returns a dict: "radiance" (H, W, 3) summed over the samples, and the
    sample means "depth" (H, W, 0 on a miss), "normal" (H, W, 3), "albedo"
    (H, W, 3) and "hit_mask" (H, W). Depth and normal are continuous in
    the geometry, so they carry the position signal of inverse rendering
    (apps/fit.py); with `cfg.fused_bounce=False`, or on an unfinalized
    scene, every output is differentiable with respect to the scene's
    tensor leaves.
    """
    device = device_or_raise(device)
    frame = camera_mod.derive(camera, cfg.aspect_ratio)
    target, mats = _scene_on(scene, device)
    n = cfg.num_pixels
    zeros = [torch.zeros(shape, dtype=torch.float32, device=device)
             for shape in ((n, 3), (n,), (n, 3), (n, 3), (n,))]
    rad, depth, norm, alb, mask = zeros
    for words in threefry.split(key, samples):
        rays, ctx = camera_mod.generate_rays(frame, words, cfg.width,
                                             cfg.height, device=device)
        hit = _closest_hit(target, rays, cfg.tmin)
        mat = gather(mats, hit.material_id)
        valid = hit.valid[:, None]
        rad = rad + _trace(scene, target, mats, rays, ctx, cfg)
        depth = depth + torch.where(hit.valid, hit.t, torch.zeros_like(hit.t))
        norm = norm + hit.normal
        alb = alb + torch.where(valid, mat.albedo, torch.zeros_like(mat.albedo))
        mask = mask + hit.valid.to(torch.float32)
    h, w = cfg.height, cfg.width
    inv = 1.0 / samples
    return {
        "radiance": rad.reshape(h, w, 3),
        "depth": (depth * inv).reshape(h, w),
        "normal": (norm * inv).reshape(h, w, 3),
        "albedo": (alb * inv).reshape(h, w, 3),
        "hit_mask": (mask * inv).reshape(h, w),
    }


def render(scene: Scene, camera: camera_mod.Camera, cfg: RenderConfig,
           key: np.ndarray | None = None, device="cuda") -> Film:
    """Full offline render: accumulate cfg.spp over passes into a Film."""
    with span("integrator.render"):
        device = device_or_raise(device)
        if key is None:
            key = threefry.key(cfg.seed)
        film = Film.create(cfg.width, cfg.height, device=device)
        for i, chunk in enumerate(cfg.passes()):
            pass_key = threefry.fold_in(key, i)
            film = film.add(render_pass(scene, camera, pass_key, cfg, chunk,
                                        device=device), chunk)
        return film
