"""The plain versions of the path kernel K2 (`path_trace_reference`) and the
bounce kernel K0 (`bounce_step_reference`) against the JAX reference's
`path_trace` and `bounce_step` (their Pallas kernels in interpret mode on
the CPU), from the reference's own rays and RNG context; ten chained K0
steps against K2; and the entries' rules (device dispatch, scalar key
words, the forward-only guard). Their tile-BVH branch is held by
test_torch_megastep_bvh.py; K2 and K0 themselves are tested on a card by
test_torch_cuda.py.

Tolerances: rtol = atol = 1e-4 as for K1 (tests/test_torch_bounce_kernel.py),
smallpt by the reference's statistical rule (under 5% of values off by
> 0.2, means within 1e-2). One K0 bounce is held per ray: where the
reference and the port agree on whether the ray goes on, its carry agrees
at 1e-4, and they agree on at least 99.9% of rays (XLA's CPU code
contracts FMAs, which moves hit points by ulps; ROADMAP queue 3). The same
ulps show in whole paths through defocus_blur's metal and glass: at 24x24,
1 spp, 6 bounces, seeds 0 and 7 each leave one of 1,728 values 1.5e-4 and
1.8e-4 apart, seeds 1-5 none (the largest gap 4.4e-5); the preset tests
use seed 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import camera as jcam
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops import rng as jrng
from raytracingthenextweekcuda_tpu.ops.pallas import bounce_kernel as jbk
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays

PRESETS = ["diffuse_sphere_plane", "cornell_box", "defocus_blur",
           "smallpt_spheres", "mesh_showcase"]
SIZE = 24


def _reference_wavefront(preset, cfg_kw, seed):
    """(reference scene, reference rays and ctx, port scene, port rays and
    ctx, both configs): the reference's primary wavefront of one sample,
    given to the port as it is."""
    jscene, jcamera = getattr(jpresets, preset)()
    jscene = jfinalize(jscene, use_bvh=False)
    jcfg = JConfig(**cfg_kw)
    frame = jax.jit(jcam.derive, static_argnums=1)(jcamera, jcfg.aspect_ratio)
    jrays, jctx = jcam.generate_rays(frame, jax.random.key(seed), jcfg.width,
                                     jcfg.height)
    tscene, _ = getattr(tpresets, preset)()
    tscene = finalize(tscene, use_bvh=False)
    rays = Rays(*(torch.from_numpy(np.array(x)) for x in jrays))
    ctx = rng.RayCtx(torch.from_numpy(np.array(jctx.pixel_id).astype(np.int64)),
                     int(jctx.base0), int(jctx.base1))
    return jscene, jrays, jctx, tscene, rays, ctx, jcfg, RenderConfig(**cfg_kw)


def _path_both(preset, cfg_kw, seed=1):
    jscene, jrays, jctx, tscene, rays, ctx, jcfg, cfg = _reference_wavefront(
        preset, cfg_kw, seed)
    ref = np.asarray(jbk.path_trace(jscene, jscene.packed, jrays, jctx, jcfg,
                                    interpret=True))
    return ref, bk.path_trace_reference(tscene.packed, rays, ctx, cfg).numpy()


@pytest.mark.parametrize("preset", PRESETS)
def test_plain_k2_matches_reference(preset):
    ref, out = _path_both(preset, dict(width=SIZE, height=SIZE, spp=1, bounces=6))
    assert out.shape == (SIZE * SIZE, 3) and np.isfinite(out).all()
    if preset == "smallpt_spheres":
        assert (np.abs(out - ref) > 0.2).mean() < 0.05
        np.testing.assert_allclose(out.mean(), ref.mean(), rtol=1e-2)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("extra", [dict(russian_roulette=True, rr_start_bounce=2),
                                   dict(sky_background=False)],
                         ids=["russian_roulette", "sky_off"])
def test_plain_k2_options_match_reference(extra):
    ref, out = _path_both("cornell_box", dict(width=16, height=16, spp=1,
                                              bounces=8, **extra), seed=3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("do_rr", [0, 1])
def test_plain_k0_matches_reference(do_rr):
    kw = dict(width=32, height=32, spp=1, bounces=4, russian_roulette=True,
              rr_start_bounce=0)
    jscene, jrays, jctx, tscene, rays, ctx, jcfg, cfg = _reference_wavefront(
        "cornell_box", kw, 5)
    n = rays.count
    # Advance both to the second bounce (hits on the walls, the spheres and
    # the boxes, with throughput below 1) on the reference's own carry.
    jstate = jbk.planar_state(jrays)
    jstate = jbk.bounce_step(jscene, jscene.packed, jstate,
                             jrng.bounce_uniforms(jctx, 0), 0, jcfg, interpret=True)
    u4 = jrng.bounce_uniforms(jctx, 1)
    ref = jbk.bounce_step(jscene, jscene.packed, jstate, u4, do_rr, jcfg,
                          interpret=True)
    state = tuple(torch.from_numpy(np.array(x[:n])) for x in jstate)
    out = bk.bounce_step_reference(tscene.packed, state,
                                   torch.from_numpy(np.array(u4)), do_rr, cfg)
    ref = [np.asarray(x[:n]) for x in ref]
    out = [x.numpy() for x in out]
    live = np.asarray(state[7]) != 0
    agree = (ref[7] != 0) == (out[7] != 0)
    assert live.mean() > 0.5 and (ref[7] != 0).any()
    assert agree.mean() >= 0.999, f"{(~agree).sum()} of {n} alive flags differ"
    for k in range(14):
        np.testing.assert_allclose(out[k][agree], ref[k][agree], rtol=1e-4,
                                   atol=1e-4, err_msg=f"row {k}")
    # Dead rays pass through unchanged.
    for k in range(14):
        if k != 7:
            np.testing.assert_array_equal(out[k][~live], state[k].numpy()[~live])
    assert (out[7][~live] == 0).all()


@pytest.mark.parametrize("rr", [False, True], ids=["plain", "russian_roulette"])
def test_ten_k0_steps_equal_k2(rr):
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=10,
                       russian_roulette=rr, rr_start_bounce=3)
    rays, ctx = tcam.generate_rays(tcam.derive(camera, 1.0),
                                   threefry.split(threefry.key(2), 1)[0], 16, 16)
    k2 = bk.path_trace_reference(scene.packed, rays, ctx, cfg)
    state = bk.planar_state(rays)
    for b in range(cfg.bounces):
        u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, b)
        state = bk.bounce_step_reference(scene.packed, state, u4,
                                         b >= cfg.rr_start_bounce, cfg)
    np.testing.assert_array_equal(torch.stack(state[11:14], 1).numpy(), k2.numpy())


def test_k2_equals_k1_on_its_rays():
    """K1 is raygen plus K2: the same pixels, sample and stream."""
    scene, camera = tpresets.defocus_blur()
    scene = finalize(scene)
    cfg = RenderConfig(width=12, height=10, spp=1, bounces=6)
    frame = tcam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.key(9), 1)
    rays, ctx = tcam.generate_rays(frame, words[0], 12, 10)
    k1 = bk.render_samples(scene.packed, frame, words, cfg, device="cpu")
    np.testing.assert_array_equal(bk.path_trace(scene.packed, rays, ctx, cfg).numpy(),
                                  k1.numpy())


def test_entries_take_the_plain_version_on_cpu():
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=8, height=8, spp=1, bounces=3)
    rays, ctx = tcam.generate_rays(tcam.derive(camera, 1.0),
                                   threefry.split(threefry.key(0), 1)[0], 8, 8)
    before = (bk.PATH_LAUNCHES, bk.BOUNCE_LAUNCHES)
    a = bk.path_trace(scene.packed, rays, ctx, cfg)
    np.testing.assert_array_equal(
        a.numpy(), bk.path_trace_reference(scene.packed, rays, ctx, cfg).numpy())
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0)
    s = bk.bounce_step(scene.packed, bk.planar_state(rays), u4, 0, cfg)
    r = bk.bounce_step_reference(scene.packed, bk.planar_state(rays), u4, 0, cfg)
    for x, y in zip(s, r):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (bk.PATH_LAUNCHES, bk.BOUNCE_LAUNCHES) == before


def test_entries_refuse_what_they_cannot_trace():
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=4, height=4, spp=2, bounces=2)
    frame = tcam.derive(camera, 1.0)
    words = threefry.split(threefry.key(0), 2)
    rays, ctx = tcam.generate_rays_multi(frame, words, 4, 4)
    with pytest.raises(ValueError, match="scalar RayCtx key words"):
        bk.path_trace(scene.packed, rays, ctx, cfg)


def test_k0_launch_checks_its_inputs():
    scene, camera = tpresets.cornell_box()
    cfg = RenderConfig(width=4, height=4, spp=1, bounces=2)
    rays, _ = tcam.generate_rays(tcam.derive(camera, 1.0),
                                 threefry.split(threefry.key(0), 1)[0], 4, 4)
    inp = bk.bounce_inputs(finalize(scene).packed, bk.planar_state(rays),
                           torch.zeros((16, 4)), 0, cfg)
    for carry in (tuple(row[:8] for row in inp.carry), inp.carry[:12]):
        with pytest.raises(ValueError, match="K0 input"):
            bk._launch_bounce(bk.BounceInputs(**{**inp.scene_fields(),
                                                 "carry": carry,
                                                 "alive": inp.alive, "u4": inp.u4,
                                                 "do_rr": False}))
    misaligned = torch.zeros(16 * 4 + 1)[1:].view(16, 4)
    with pytest.raises(ValueError, match="K0 input u4"):
        bk._launch_bounce(dataclasses.replace(inp, u4=misaligned))
    # bounce_inputs hands K0 an aligned copy of such a view.
    assert bk.bounce_inputs(finalize(scene).packed, bk.planar_state(rays), misaligned,
                            0, cfg).u4.data_ptr() % 16 == 0


def test_backward_through_k2_and_k0_raises():
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=4, height=4, spp=1, bounces=2)
    rays, ctx = tcam.generate_rays(tcam.derive(camera, 1.0),
                                   threefry.split(threefry.key(0), 1)[0], 4, 4)
    origin = rays.origin.clone().requires_grad_()
    rays = Rays(origin, rays.direction, rays.time)
    out = bk.path_trace(scene.packed, rays, ctx, cfg)
    with pytest.raises(NotImplementedError, match="fused_bounce=False"):
        out.sum().backward()
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0)
    state = bk.bounce_step(scene.packed, bk.planar_state(rays), u4, 0, cfg)
    with pytest.raises(NotImplementedError, match="fused_bounce=False"):
        state[11].sum().backward()
    # Without inputs that require grad, the outputs carry no graph.
    plain = bk.path_trace(scene.packed, Rays(origin.detach(), rays.direction,
                                             rays.time), ctx, cfg)
    assert not plain.requires_grad
