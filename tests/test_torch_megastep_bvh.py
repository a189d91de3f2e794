"""The tile-BVH branch of the bounce kernels' plain versions against the JAX
reference, and the forced megastep route of the integrator.

The reference's bounce kernels walk a tile-BVH pack with a block-consensus
skip-pointer traversal (ops/pallas/bounce_kernel.py:820-1044). Production
sends tile-BVH scenes to the sorted wavefront (K3 and K4), so this branch
is reached only when `_sorted_eligible` is forced false, as the reference's
cross-engine test does. Here the port's `render_samples_reference`,
`path_trace_reference` and `bounce_step_reference` take that branch on a
multi-leaf pack (a 40x80 UV sphere, 6,240 triangles in 12 leaves of 768,
23 nodes) and are held against the reference's `render_samples`,
`path_trace` and `bounce_step` run in interpret mode, on the same rays and
key words, at rtol = atol = 1e-4 (the reference's own engines agree to
1.2e-7 on this scene). The forced megastep render through K1's and K2's
plain versions is held against the port's sorted wavefront at 1e-4, and
the test makes sure that the forced render walked the tile-BVH and never
entered the sorted engine. The kernels themselves are held against these
plain versions on a card by test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.io.procedural import uv_sphere_mesh as juv_sphere
from raytracingthenextweekcuda_tpu.models import camera as jcam
from raytracingthenextweekcuda_tpu.models.scene import SceneBuilder as JBuilder
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops import rng as jrng
from raytracingthenextweekcuda_tpu.ops.pallas import bounce_kernel as jbk
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.io.procedural import uv_sphere_mesh
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models.scene import SceneBuilder, finalize
from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.cuda import work
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays

CAMERA = dict(eye=(0, 0.4, 2.6), center=(0, 0, 0), fov=45.0, aperture=0.0,
              focus_distance=2.6, time1=1.0)
SIZE = dict(width=20, height=16)


def _build(builder, sphere_mesh, emissive):
    """The reference's `_mesh_scene` (tests/test_sorted_wavefront.py) with
    a 40x80 sphere; `emissive` gives the mesh additive emission."""
    b = builder()
    b.lambertian(0, (0.73, 0.73, 0.73))
    b.metal(1, (0.9, 0.6, 0.2), 0.1)
    b.emission(2, (1.0, 1.0, 1.0), 4.0)
    if emissive:
        b.material(3, 0, (0.5, 0.6, 0.7), 0.0, emission=(0.4, 0.3, 0.2))
    b.plane((0, -1.05, 0), (0, 1, 0), (5, 0, 5), 2, 0)
    b.sphere((0, 4, 0), 2.0, 2)
    b.mesh(sphere_mesh(0.9, (0, 0, 0), 40, 80), 3 if emissive else 1)
    return b.build()


@pytest.fixture(scope="module", params=[False, True], ids=["metal", "emissive"])
def scenes(request):
    """(reference scene and camera, port scene and camera) on tile-BVH
    packs of the same mesh."""
    from raytracingthenextweekcuda_tpu.models.camera import Camera as JCamera

    jscene = jfinalize(_build(JBuilder, juv_sphere, request.param), use_bvh=True)
    tscene = finalize(_build(SceneBuilder, uv_sphere_mesh, request.param),
                      use_bvh=True)
    assert tscene.packed.bvh_bounds.shape[1] >= 20
    assert tscene.packed.leaf_tiles.shape[1] >= 12
    assert tscene.packed.has_emission == request.param
    return (jscene, JCamera.make(**CAMERA)), (tscene, tcam.Camera.make(**CAMERA))


def _reference_frame(jcamera, aspect_ratio):
    jf = jax.jit(jcam.derive, static_argnums=1)(jcamera, aspect_ratio)
    return tcam.CameraFrame(**{f: torch.from_numpy(np.array(getattr(jf, f)))
                               for f in jf._fields})


@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_plain_k1_bvh_matches_reference(scenes, rr):
    (jscene, jcamera), (tscene, _) = scenes
    kw = dict(**SIZE, spp=2, bounces=4, russian_roulette=rr, rr_start_bounce=1)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    frame = jax.jit(jcam.derive, static_argnums=1)(jcamera, jcfg.aspect_ratio)
    ref = np.asarray(jbk.render_samples(jscene, jscene.packed, frame,
                                        jax.random.split(jax.random.key(3), 2),
                                        jcfg, interpret=True))
    work.reset()
    out = bk.render_samples_reference(
        tscene.packed, _reference_frame(jcamera, cfg.aspect_ratio),
        threefry.split(threefry.key(3), 2), cfg).numpy()
    # The walk's work: more box tests than bounces, and each leaf visit
    # counts the leaf's triangles, not its padded tile.
    packed = tscene.packed
    counts, leaf_tile = work.WORK, packed.trih.shape[1] // packed.leaf_tiles.shape[1]
    assert counts["leaf_visits"] > 0 and counts["box_tests"] > counts["bounces"]
    assert counts["leaf_visits"] < counts["triangle_tests"] < (
        counts["leaf_visits"] * leaf_tile)
    assert out.shape == (cfg.num_pixels, 3) and np.isfinite(out).all()
    assert out.mean() > 0.01
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def _reference_wavefront(scenes, kw, seed):
    (jscene, jcamera), (tscene, _) = scenes
    jcfg = JConfig(**kw)
    frame = jax.jit(jcam.derive, static_argnums=1)(jcamera, jcfg.aspect_ratio)
    jrays, jctx = jcam.generate_rays(frame, jax.random.key(seed), jcfg.width,
                                     jcfg.height)
    rays = Rays(*(torch.from_numpy(np.array(x)) for x in jrays))
    ctx = rng.RayCtx(torch.from_numpy(np.array(jctx.pixel_id).astype(np.int64)),
                     int(jctx.base0), int(jctx.base1))
    return jscene, jrays, jctx, jcfg, tscene, rays, ctx, RenderConfig(**kw)


def test_plain_k2_bvh_matches_reference(scenes):
    kw = dict(**SIZE, spp=1, bounces=4, russian_roulette=True, rr_start_bounce=2)
    jscene, jrays, jctx, jcfg, tscene, rays, ctx, cfg = _reference_wavefront(
        scenes, kw, 5)
    ref = np.asarray(jbk.path_trace(jscene, jscene.packed, jrays, jctx, jcfg,
                                    interpret=True))
    out = bk.path_trace_reference(tscene.packed, rays, ctx, cfg).numpy()
    assert out.mean() > 0.01
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("do_rr", [0, 1])
def test_plain_k0_bvh_matches_reference(scenes, do_rr):
    kw = dict(**SIZE, spp=1, bounces=4, russian_roulette=True, rr_start_bounce=0)
    jscene, jrays, jctx, jcfg, tscene, rays, ctx, cfg = _reference_wavefront(
        scenes, kw, 6)
    n = rays.count
    # One bounce on the reference's carry, then the second on both.
    jstate = jbk.bounce_step(jscene, jscene.packed, jbk.planar_state(jrays),
                             jrng.bounce_uniforms(jctx, 0), 0, jcfg, interpret=True)
    u4 = jrng.bounce_uniforms(jctx, 1)
    ref = jbk.bounce_step(jscene, jscene.packed, jstate, u4, do_rr, jcfg,
                          interpret=True)
    state = tuple(torch.from_numpy(np.array(x[:n])) for x in jstate)
    out = bk.bounce_step_reference(tscene.packed, state,
                                   torch.from_numpy(np.array(u4)), do_rr, cfg)
    live = state[7].numpy() != 0
    assert live.mean() > 0.3
    np.testing.assert_array_equal(out[7].numpy(), np.asarray(ref[7])[:n])
    for k in range(14):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k])[:n],
                                   rtol=1e-4, atol=1e-4, err_msg=f"row {k}")


def _no_sorted_engine(*args, **kw):
    raise AssertionError("the forced megastep entered the sorted wavefront")


@pytest.fixture
def force_megastep(monkeypatch):
    """A function that forces the megastep route (the reference's oracle
    patch), makes the sorted engine raise, and returns the list that each
    plain tile-BVH walk appends to from then on."""
    def force():
        calls = []
        walk = bk._tile_bvh_closest
        monkeypatch.setattr(integrator, "_sorted_eligible", lambda *_: False)
        monkeypatch.setattr(integrator, "_trace_sorted", _no_sorted_engine)
        monkeypatch.setattr(integrator, "_render_pass_sorted", _no_sorted_engine)
        monkeypatch.setattr(bk, "_tile_bvh_closest",
                            lambda *a: calls.append(1) or walk(*a))
        return calls
    return force


@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_forced_megastep_render_matches_sorted_wavefront(scenes, force_megastep, rr):
    """render -> render_pass -> K1 (plain) on the forced route."""
    _, (tscene, camera) = scenes
    cfg = RenderConfig(**SIZE, spp=2, bounces=4, spp_per_pass=2,
                       russian_roulette=rr, rr_start_bounce=2)
    sorted_img = integrator.render(tscene, camera, cfg, device="cpu").accum.numpy()
    walks = force_megastep()
    forced = integrator.render(tscene, camera, cfg, device="cpu").accum.numpy()
    assert len(walks) >= cfg.bounces  # one walk a bounce while rays live
    assert forced.mean() > 0.01
    np.testing.assert_allclose(forced, sorted_img, rtol=1e-4, atol=1e-4)


def test_forced_megastep_gbuffer_matches_sorted_wavefront(scenes, force_megastep):
    """render_gbuffer -> trace -> K2 (plain) on the forced route."""
    _, (tscene, camera) = scenes
    cfg = RenderConfig(**SIZE, spp=2, bounces=4)
    key = threefry.key(4)
    sorted_g = integrator.render_gbuffer(tscene, camera, key, cfg, 2, device="cpu")
    walks = force_megastep()
    g = integrator.render_gbuffer(tscene, camera, key, cfg, 2, device="cpu")
    assert len(walks) >= 2 * cfg.bounces
    for name in g:
        np.testing.assert_allclose(g[name].numpy(), sorted_g[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_tile_bvh_inputs_and_launch_checks(scenes):
    """The kernels' inputs carry the pack's node, meta and Havel arrays;
    the wrapper checks them before it builds anything."""
    _, (tscene, camera) = scenes
    packed = tscene.packed
    cfg = RenderConfig(**SIZE, spp=1, bounces=2)
    inp = bk.render_inputs(packed, tcam.derive(camera, cfg.aspect_ratio),
                           threefry.split(threefry.key(0), 1), cfg, device="cpu")
    assert inp.counts == (1, 1, 0, 0, 0)  # the flat rows: spheres and planes
    assert inp.leaf_tile == 768 and inp.trih.shape == (20, packed.trih.shape[1])
    np.testing.assert_array_equal(inp.bvh_meta.numpy(), packed.bvh_meta)
    np.testing.assert_array_equal(inp.bvh_bounds.numpy(), packed.bvh_bounds)
    bad = bk.RenderInputs(**{**inp.scene_fields(), "trih": inp.trih[:12]},
                          frame=inp.frame, words=inp.words, pid=inp.pid,
                          width=inp.width, height=inp.height)
    with pytest.raises(ValueError, match="K1 input"):
        bk._launch(bad)
