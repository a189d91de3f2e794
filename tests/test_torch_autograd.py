"""Gradients of the port's differentiable engine (the torch wavefront with
`fused_bounce=False`, or any unfinalized scene) against `jax.grad` of the
JAX reference on the same scenes and keys, at rtol = 1e-3 and atol = 1e-6;
a finite-difference check; the losses and gradients of `apps/fit.py`; and
the guard that makes a backward through the forward-only kernels raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingthenextweekcuda_tpu.apps import fit as jfit
from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.camera import Camera as JCamera
from raytracingthenextweekcuda_tpu.models.scene import SceneBuilder as JBuilder
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu_torch.apps import fit
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    SceneBuilder,
    finalize,
    with_leaves,
)
from raytracingthenextweekcuda_tpu_torch.ops import threefry

RTOL, ATOL = 1e-3, 1e-6


def _set(array, index, value: torch.Tensor) -> torch.Tensor:
    """`array` (numpy) with `array[index]` replaced by the tensor `value`,
    in the autograd graph; the other entries keep their exact values."""
    base = torch.from_numpy(np.array(array, np.float32))
    onehot = torch.zeros_like(base)
    onehot[index] = 1.0
    return base * (1.0 - onehot) + onehot * value


@pytest.mark.parametrize("finalized", [False, True], ids=["plain", "k3_recompute"])
def test_depth_gradient_matches_jax(finalized):
    """tests/test_fit.py's depth-mean case: d mean(depth) / d centre z."""
    cfg_kw = dict(width=16, height=16, spp=2, bounces=2, fused_bounce=False)
    jscene, jcamera = jpresets.diffuse_sphere_plane()
    tscene, tcamera = presets.diffuse_sphere_plane()
    if finalized:
        jscene, tscene = jfinalize(jscene), finalize(tscene)

    def jloss(cz):
        sph = jscene.spheres._replace(
            center0=jscene.spheres.center0.at[0, 2].set(cz),
            center1=jscene.spheres.center1.at[0, 2].set(cz))
        g = jintegrator.render_gbuffer(jscene._replace(spheres=sph), jcamera,
                                       jax.random.key(1), JConfig(**cfg_kw), 2)
        return jnp.mean(g["depth"])

    jval, jgrad = jax.value_and_grad(jloss)(jnp.float32(-1.0))
    cz = torch.tensor(-1.0, requires_grad=True)
    sph = tscene.spheres
    scene = with_leaves(tscene, {"spheres.center0": _set(sph.center0, (0, 2), cz),
                                 "spheres.center1": _set(sph.center1, (0, 2), cz)})
    g = integrator.render_gbuffer(scene, tcamera, threefry.key(1),
                                  RenderConfig(**cfg_kw), 2, device="cpu")
    loss = g["depth"].mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4, atol=1e-4)
    assert np.isfinite(float(cz.grad)) and abs(float(cz.grad)) > 1e-4
    np.testing.assert_allclose(float(cz.grad), float(jgrad), rtol=RTOL, atol=ATOL)


def _albedo_scene(builder):
    b = builder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.emission(1, (1, 1, 1), 2.0)
    b.sphere((0, 0, -1), 0.5, 0)
    b.sphere((0, 0, 0), 20.0, 1)  # emissive enclosure lights everything
    return b.build()


def test_albedo_gradient_matches_jax_and_finite_difference():
    """tests/test_integrator.py's albedo case: d mean(render_pass) / d
    albedo, through an unfinalized scene (the differentiable engine under
    the default fused_bounce=True)."""
    kw = dict(width=8, height=8, spp=4, bounces=4, spp_per_pass=4)
    look = dict(eye=(0.0, 0.0, 0.0), center=(0.0, 0.0, -1.0), fov=90.0,
                aperture=0.0, focus_distance=1.0)
    jscene, jcamera = _albedo_scene(JBuilder), JCamera.make(**look)
    tscene, tcamera = _albedo_scene(SceneBuilder), Camera.make(**look)

    def jloss(r):
        mats = jscene.materials._replace(
            albedo=jscene.materials.albedo.at[0, 0].set(r))
        img = jintegrator.render_pass(jscene._replace(materials=mats), jcamera,
                                      jax.random.key(5), JConfig(**kw), 4)
        return jnp.mean(img)

    def tloss(r):
        scene = with_leaves(tscene, {
            "materials.albedo": _set(tscene.materials.albedo, (0, 0), r)})
        return integrator.render_pass(scene, tcamera, threefry.key(5),
                                      RenderConfig(**kw), 4, device="cpu").mean()

    jgrad = jax.grad(jloss)(jnp.float32(0.5))
    r = torch.tensor(0.5, requires_grad=True)
    tloss(r).backward()
    assert np.isfinite(float(r.grad)) and float(r.grad) > 0
    np.testing.assert_allclose(float(r.grad), float(jgrad), rtol=RTOL, atol=ATOL)
    eps = 1e-2
    with torch.no_grad():
        fd = (tloss(torch.tensor(0.5 + eps)) - tloss(torch.tensor(0.5 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(r.grad), float(fd), rtol=5e-2, atol=1e-4)


def _jax_fit_loss(params, target, camera, key, cfg, spp):
    """The loss of the reference's run_fit (its loss_fn), rebuilt from its
    _make_scene and render_gbuffer."""
    g = jintegrator.render_gbuffer(jfit._make_scene(params["centers"],
                                                    params["albedos"]),
                                   camera, key, cfg, spp)
    both = jax.lax.stop_gradient((g["hit_mask"] > 0.5) & (target["hit_mask"] > 0.5))
    rad = jnp.mean((g["radiance"] / spp - target["radiance"] / spp) ** 2)
    depth = jnp.mean(jnp.where(both, (g["depth"] - target["depth"]) ** 2, 0.0))
    normal = jnp.mean(jnp.where(both[..., None], (g["normal"] - target["normal"]) ** 2, 0.0))
    albedo = jnp.mean(jnp.where(both[..., None], (g["albedo"] - target["albedo"]) ** 2, 0.0))
    return rad + 0.5 * depth + 0.2 * normal + 0.5 * albedo


def test_fit_loss_and_gradients_match_jax():
    size, spp = 16, 2
    cam = dict(eye=(0.0, 0.6, 2.2), center=(0.0, 0.0, 0.0), fov=45.0,
               aperture=0.0, focus_distance=2.2)
    jcfg = JConfig(width=size, height=size, spp=spp, bounces=4, spp_per_pass=spp,
                   fused_bounce=False)
    key = jax.random.key(0)
    jtarget = jintegrator.render_gbuffer(
        jfit._make_scene(jnp.asarray(fit.TRUE_CENTERS, jnp.float32),
                         jnp.asarray(fit.TRUE_ALBEDOS, jnp.float32)),
        JCamera.make(**cam), key, jcfg, spp)
    params = {"centers": jnp.asarray(fit.INIT_CENTERS, jnp.float32),
              "albedos": jnp.asarray(fit.INIT_ALBEDOS, jnp.float32)}
    jval, jgrad = jax.value_and_grad(_jax_fit_loss)(
        params, jtarget, JCamera.make(**cam), jax.random.fold_in(key, 1), jcfg, spp)

    cfg = fit.fit_config(size, size, spp)
    tkey = threefry.key(0)
    target = integrator.render_gbuffer(
        fit.make_scene(torch.tensor(fit.TRUE_CENTERS), torch.tensor(fit.TRUE_ALBEDOS)),
        fit.fit_camera(), tkey, cfg, spp, device="cpu")
    for name in ("radiance", "depth", "normal", "albedo", "hit_mask"):
        np.testing.assert_allclose(target[name].numpy(), np.asarray(jtarget[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    centers = torch.tensor(fit.INIT_CENTERS, requires_grad=True)
    albedos = torch.tensor(fit.INIT_ALBEDOS, requires_grad=True)
    loss = fit.fit_loss(centers, albedos, target, fit.fit_camera(),
                        threefry.fold_in(tkey, 1), cfg, spp, "cpu")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4, atol=1e-6)
    for name, t in (("centers", centers), ("albedos", albedos)):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_fit_mesh_gradient_matches_jax(monkeypatch):
    """run_fit_mesh's loss gradient with respect to the scale, through the
    tile-BVH path: the kernels select on the anchor's pack, the recompute
    reads the deformed vertices."""
    monkeypatch.setenv("RTNW_BVH_CACHE", "")  # the reference caches under $HOME
    size, spp = 16, 2
    cam = dict(eye=(0.0, 0.6, 2.2), center=(0.0, 0.0, 0.0), fov=45.0,
               aperture=0.0, focus_distance=2.2)
    jcfg = JConfig(width=size, height=size, spp=spp, bounces=4, spp_per_pass=spp,
                   fused_bounce=False)
    true_scale = np.asarray(fit.TRUE_SCALE, np.float32)
    jbase = jfit._make_mesh_scene()

    def jdeform(scene, s3):
        return scene._replace(triangles=scene.triangles._replace(
            vertices=scene.triangles.vertices * (1.0 + s3)))

    key = jax.random.key(0)
    jtarget = jintegrator.render_gbuffer(jfinalize(jdeform(jbase, true_scale)),
                                         JCamera.make(**cam), key, jcfg, spp)
    janchor = jfinalize(jdeform(jbase, np.zeros(3, np.float32)))

    def jloss(s3):
        g = jintegrator.render_gbuffer(jdeform(janchor, s3), JCamera.make(**cam),
                                       key, jcfg, spp)
        near = jax.lax.stop_gradient(
            (g["hit_mask"] > 0.5) & (jtarget["hit_mask"] > 0.5)
            & (g["depth"] < 10.0) & (jtarget["depth"] < 10.0))
        rad = jnp.mean((g["radiance"] / spp - jtarget["radiance"] / spp) ** 2)
        normal = jnp.mean(jnp.where(near[..., None],
                                    (g["normal"] - jtarget["normal"]) ** 2, 0.0))
        return rad + 0.5 * normal

    s0 = jnp.asarray([0.02, -0.03, 0.01], jnp.float32)
    jval, jgrad = jax.value_and_grad(jloss)(s0)

    cfg = fit.fit_config(size, size, spp)
    tkey = threefry.key(0)
    base = fit.make_mesh_scene()
    target = integrator.render_gbuffer(fit.refinalize(base, true_scale),
                                       fit.fit_camera(), tkey, cfg, spp, device="cpu")
    anchor = fit.refinalize(base, np.zeros(3, np.float32))
    assert anchor.packed.leaf_bounds is not None  # the tile-BVH path
    scale = torch.tensor(np.asarray(s0), requires_grad=True)
    loss = fit.mesh_fit_loss(scale, anchor, torch.zeros(3), target,
                             fit.fit_camera(), tkey, cfg, spp, "cpu")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4, atol=1e-6)
    assert torch.isfinite(scale.grad).all() and scale.grad.abs().max() > 0
    np.testing.assert_allclose(scale.grad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=ATOL)


def test_backward_through_fused_render_raises():
    scene, camera = presets.cornell_box()
    scene = finalize(scene)
    c = torch.tensor(np.asarray(scene.spheres.center0), requires_grad=True)
    live = with_leaves(scene, {"spheres.center0": c, "spheres.center1": c})
    cfg = RenderConfig(width=6, height=6, spp=1, bounces=3)
    key = threefry.key(0)
    img = integrator.render_pass(live, camera, key, cfg, 1, device="cpu")  # K1
    with pytest.raises(NotImplementedError, match="fused_bounce=False"):
        img.sum().backward()
    g = integrator.render_gbuffer(live, camera, key, cfg, 1, device="cpu")  # K3 and K2
    with pytest.raises(NotImplementedError, match="fused_bounce=False"):
        g["radiance"].sum().backward()
    # The guard adds exactly zero: the fused forward is unchanged.
    np.testing.assert_array_equal(
        img.detach().numpy(), integrator.render_pass(scene, camera, key, cfg, 1,
                                                  device="cpu").numpy())
    # The same scene with fused_bounce=False differentiates.
    g = integrator.render_gbuffer(live, camera, key,
                                  RenderConfig(width=6, height=6, spp=1, bounces=3,
                                               fused_bounce=False), 1, device="cpu")
    g["depth"].mean().backward()
    assert torch.isfinite(c.grad).all()


@pytest.mark.parametrize("mesh", [False, True], ids=["spheres", "mesh"])
def test_run_fit_steps_and_writes_png(mesh, tmp_path, monkeypatch):
    monkeypatch.setenv("RTNW_BVH_CACHE", "")
    run = fit.run_fit_mesh if mesh else fit.run_fit
    losses = []
    out = tmp_path / "fit.png"
    rc = run(steps=3, out=str(out), width=16, height=16, spp=2, device="cpu",
             verbose=False, losses=losses)
    assert rc in (0, 1) and len(losses) == 3 and np.isfinite(losses).all()
    from raytracingthenextweekcuda_tpu_torch.io.image import read_png
    assert read_png(str(out)).shape == (16, 32, 3)  # target and fit side by side


def test_cli_fit_defaults(monkeypatch):
    from raytracingthenextweekcuda_tpu_torch import cli

    calls = []
    monkeypatch.setattr(fit, "run_fit", lambda **kw: calls.append(("fit", kw)) or 0)
    monkeypatch.setattr(fit, "run_fit_mesh", lambda **kw: calls.append(("mesh", kw)) or 0)
    assert cli.main(["fit", "--device", "cpu"]) == 0
    assert cli.main(["fit", "--mesh", "--steps", "5", "--out", "m.png"]) == 0
    assert calls == [("fit", dict(steps=60, out="fit.png", device="cpu")),
                     ("mesh", dict(steps=5, out="m.png", device="cuda"))]
