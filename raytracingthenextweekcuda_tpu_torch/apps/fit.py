"""Inverse rendering: fit scene parameters to a target render by gradient
descent through the differentiable torch wavefront (counterpart of
raytracingthenextweekcuda_tpu/apps/fit.py).

    rtnw-torch fit [--steps 60] [--out fit.png] [--device cuda]
    rtnw-torch fit --mesh [--steps 40]

`run_fit` recovers two sphere centres and albedos on an unfinalized scene
(the plain torch intersects, ops/intersect.py); `run_fit_mesh` recovers an
anisotropic scale of a triangle mesh on a tile-BVH scene, where K3 and K4
select the hits of the anchor scene's pack and the torch recompute reads the
deformed vertices. Both render G-buffers with `fused_bounce=False` and step
`torch.optim.Adam` with the reference's optax settings (lr as given, betas
0.9 and 0.999, eps 1e-8).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    Scene,
    SceneBuilder,
    finalize,
    with_leaves,
)
from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda.launch import device_or_raise

TRUE_CENTERS = ((-0.45, 0.0, 0.0), (0.5, 0.05, -0.2))
TRUE_ALBEDOS = ((0.8, 0.2, 0.2), (0.2, 0.3, 0.8))
INIT_CENTERS = ((-0.2, 0.1, 0.1), (0.25, -0.05, 0.0))
INIT_ALBEDOS = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
TRUE_SCALE = (0.18, -0.15, 0.08)


def fit_camera() -> Camera:
    return Camera.make(eye=(0.0, 0.6, 2.2), center=(0.0, 0.0, 0.0), fov=45.0,
                       aperture=0.0, focus_distance=2.2)


def fit_config(width: int, height: int, spp: int) -> RenderConfig:
    """The fit's render: 4 bounces, one pass, the differentiable engine."""
    return RenderConfig(width=width, height=height, spp=spp, bounces=4,
                        spp_per_pass=spp, fused_bounce=False)


def make_scene(centers: torch.Tensor, albedos: torch.Tensor) -> Scene:
    """Two Lambertian spheres on a ground plane under an emissive dome; the
    spheres' centres and albedos are the (2, 3) tensors given."""
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.lambertian(1, (0.5, 0.5, 0.5))
    b.lambertian(2, (0.8, 0.8, 0.8))
    b.emission(3, (1.0, 1.0, 1.0), 1.5)
    b.sphere((0.0, 0.0, 0.0), 0.4, 0)
    b.sphere((0.0, 0.0, 0.0), 0.4, 1)
    b.plane((0.0, -0.4, 0.0), (0.0, 1.0, 0.0), (50.0, 0.0, 50.0), 2, 2)
    b.sphere((0.0, 0.0, 0.0), 30.0, 3)  # emissive dome
    scene = b.build()

    def rows(params, rest):
        return torch.cat([params, torch.as_tensor(rest[2:]).to(params.device)])

    center = rows(centers, scene.spheres.center0)
    return with_leaves(scene, {
        "spheres.center0": center,
        "spheres.center1": center,
        "materials.albedo": rows(albedos, scene.materials.albedo),
    })


def fit_loss(centers, albedos, target: dict, camera, key, cfg: RenderConfig,
             spp: int, device) -> torch.Tensor:
    """Radiance plus G-buffer loss of `run_fit`.

    Radiance alone cannot move geometry: in a diffuse scene a pixel's
    radiance is a product of albedos at fixed path topology, so its
    derivative with respect to the centres is zero. Depth and normal are
    continuous in the geometry inside the silhouettes, and albedo pins the
    colours; those terms count where both renders hit."""
    g = integrator.render_gbuffer(make_scene(centers, albedos), camera, key,
                                  cfg, spp, device=device)
    both = (g["hit_mask"] > 0.5) & (target["hit_mask"] > 0.5)
    zero = torch.zeros((), device=g["depth"].device)
    rad = torch.mean((g["radiance"] / spp - target["radiance"] / spp) ** 2)
    depth = torch.mean(torch.where(both, (g["depth"] - target["depth"]) ** 2, zero))
    normal = torch.mean(torch.where(both[..., None],
                                    (g["normal"] - target["normal"]) ** 2, zero))
    albedo = torch.mean(torch.where(both[..., None],
                                    (g["albedo"] - target["albedo"]) ** 2, zero))
    return rad + 0.5 * depth + 0.2 * normal + 0.5 * albedo


def _write_side_by_side(out: str, target_rad, final_rad) -> None:
    from raytracingthenextweekcuda_tpu_torch.io.image import write_png
    from raytracingthenextweekcuda_tpu_torch.models.film import tonemap_u8

    side = torch.cat([target_rad.detach(), final_rad.detach()], dim=1)
    write_png(out, tonemap_u8(side).cpu().numpy()[::-1])


def run_fit(steps: int = 60, out: str = "fit.png", width: int = 96,
            height: int = 96, spp: int = 8, lr: float = 2e-2, seed: int = 0,
            device="cuda", verbose: bool = True, losses: list | None = None) -> int:
    """Fit the two spheres' centres and albedos; 0 when the loss halves.
    `losses`, when given, receives each step's loss."""
    device = device_or_raise(device)
    camera = fit_camera()
    cfg = fit_config(width, height, spp)
    key = threefry.key(seed)

    def param(values):
        return torch.tensor(values, dtype=torch.float32, device=device)

    with torch.no_grad():
        target = integrator.render_gbuffer(
            make_scene(param(TRUE_CENTERS), param(TRUE_ALBEDOS)), camera, key,
            cfg, spp, device=device)
    centers = param(INIT_CENTERS).requires_grad_()
    albedos = param(INIT_ALBEDOS).requires_grad_()
    opt = torch.optim.Adam([centers, albedos], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    t0 = time.perf_counter()
    loss0 = None
    for i in range(steps):
        opt.zero_grad()
        loss = fit_loss(centers, albedos, target, camera,
                        threefry.fold_in(key, i + 1), cfg, spp, device)
        loss.backward()
        opt.step()
        with torch.no_grad():
            albedos.clamp_(0.0, 1.0)
        value = float(loss.detach())
        if loss0 is None:
            loss0 = value
        if losses is not None:
            losses.append(value)
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"  step {i:3d}  loss {value:.5f}", file=sys.stderr)

    final_loss = value
    if verbose:
        center_err = float((centers.detach() - param(TRUE_CENTERS)).abs().max())
        albedo_err = float((albedos.detach() - param(TRUE_ALBEDOS)).abs().max())
        print(f"fit: loss {loss0:.5f} -> {final_loss:.5f} in "
              f"{time.perf_counter() - t0:.1f}s; max center err {center_err:.3f}, "
              f"max albedo err {albedo_err:.3f}", file=sys.stderr)
    with torch.no_grad():
        final = integrator.render_pass(make_scene(centers, albedos), camera, key,
                                       cfg, spp, device=device) / spp
    _write_side_by_side(out, target["radiance"] / spp, final)
    return 0 if final_loss < loss0 * 0.5 else 1


def make_mesh_scene(n_lat: int = 12, n_lon: int = 24) -> Scene:
    """A diffuse UV-sphere mesh on a ground plane under an emissive dome:
    576 triangles at the defaults, so `finalize` builds a tile-BVH."""
    from raytracingthenextweekcuda_tpu_torch.io.procedural import uv_sphere_mesh

    b = SceneBuilder()
    b.lambertian(0, (0.7, 0.35, 0.25))
    b.lambertian(1, (0.8, 0.8, 0.8))
    b.emission(2, (1.0, 1.0, 1.0), 1.5)
    b.mesh(uv_sphere_mesh(0.45, (0.0, 0.05, 0.0), n_lat, n_lon), 0)
    b.plane((0.0, -0.4, 0.0), (0.0, 1.0, 0.0), (50.0, 0.0, 50.0), 2, 1)
    b.sphere((0.0, 0.0, 0.0), 30.0, 2)  # emissive dome
    return b.build()


def refinalize(base: Scene, scale: np.ndarray) -> Scene:
    """`base` with its vertices scaled per axis by 1 + `scale`, finalized:
    the tile-BVH rebuild outside the gradient."""
    verts = np.asarray(base.triangles.vertices, np.float32)
    scaled = verts * (np.float32(1.0) + np.asarray(scale, np.float32))
    return finalize(with_leaves(base, {"triangles.vertices": scaled}))


def mesh_fit_loss(scale, anchor: Scene, anchor_scale, target: dict, camera,
                  key, cfg: RenderConfig, spp: int, device) -> torch.Tensor:
    """Loss of `run_fit_mesh`: the anchor's vertices deformed by the
    relative scale from `anchor_scale` to `scale`, selected by the anchor's
    pack. Radiance (with the target's key, so correlated noise cancels)
    plus the normal AOV where both renders hit near geometry; no depth
    term (its fixed-topology gradients are dominated by grazing planes)."""
    rel = (1.0 + scale) / (1.0 + anchor_scale) - 1.0
    verts = torch.as_tensor(anchor.triangles.vertices, device=scale.device)
    g = integrator.render_gbuffer(
        with_leaves(anchor, {"triangles.vertices": verts * (1.0 + rel)}),
        camera, key, cfg, spp, device=device)
    near = ((g["hit_mask"] > 0.5) & (target["hit_mask"] > 0.5)
            & (g["depth"] < 10.0) & (target["depth"] < 10.0))
    zero = torch.zeros((), device=g["depth"].device)
    rad = torch.mean((g["radiance"] / spp - target["radiance"] / spp) ** 2)
    normal = torch.mean(torch.where(near[..., None],
                                    (g["normal"] - target["normal"]) ** 2, zero))
    return rad + 0.5 * normal


def run_fit_mesh(steps: int = 40, out: str = "fit_mesh.png", width: int = 96,
                 height: int = 96, spp: int = 8, lr: float = 1.5e-2,
                 seed: int = 0, refresh: int = 8, device="cuda",
                 verbose: bool = True, losses: list | None = None) -> int:
    """Fit an anisotropic vertex scale (v' = v * (1 + scale)) through the
    tile-BVH path; every `refresh` steps the scene is finalized again at
    the current scale, so the selection follows the geometry. 0 when the
    loss halves; `losses`, when given, receives each step's loss."""
    device = device_or_raise(device)
    camera = fit_camera()
    cfg = fit_config(width, height, spp)
    key = threefry.key(seed)
    base = make_mesh_scene()
    true_scale = np.asarray(TRUE_SCALE, np.float32)
    with torch.no_grad():
        target = integrator.render_gbuffer(refinalize(base, true_scale), camera,
                                           key, cfg, spp, device=device)
    scale = torch.zeros((3,), dtype=torch.float32, device=device, requires_grad=True)
    opt = torch.optim.Adam([scale], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def snapshot():
        s = scale.detach().clone()
        return refinalize(base, s.cpu().numpy()), s

    t0 = time.perf_counter()
    loss0 = None
    anchor, anchor_scale = snapshot()
    for i in range(steps):
        if refresh and i and i % refresh == 0:
            anchor, anchor_scale = snapshot()
        opt.zero_grad()
        loss = mesh_fit_loss(scale, anchor, anchor_scale, target, camera, key,
                             cfg, spp, device)
        loss.backward()
        opt.step()
        value = float(loss.detach())
        if loss0 is None:
            loss0 = value
        if losses is not None:
            losses.append(value)
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"  step {i:3d}  loss {value:.5f}", file=sys.stderr)

    final_loss = value
    if verbose:
        err = float(np.abs(scale.detach().cpu().numpy() - true_scale).max())
        print(f"fit --mesh: loss {loss0:.5f} -> {final_loss:.5f} in "
              f"{time.perf_counter() - t0:.1f}s; max scale err {err:.3f}",
              file=sys.stderr)
    with torch.no_grad():
        final = integrator.render_pass(snapshot()[0], camera, key, cfg, spp,
                                       device=device) / spp
    _write_side_by_side(out, target["radiance"] / spp, final)
    return 0 if final_loss < loss0 * 0.5 else 1


__all__ = ["fit_loss", "make_mesh_scene", "make_scene", "mesh_fit_loss",
           "refinalize", "run_fit", "run_fit_mesh"]
