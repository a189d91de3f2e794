"""The plain version of the render kernel K1 against the JAX reference's
render_pass (its Pallas kernel run in interpret mode on the CPU), and the
wrapper's device rules. K1 itself is tested on a card by test_torch_cuda.py.

Both sides get the same inputs: the packed scene rows are bit-equal by
construction (test_torch_scene.py), the key words are jax.random's
(test_torch_rng.py), and the camera frame is the one the reference derives
under jit. The port's own frame is held to the reference's at 1e-6
(test_torch_camera_film.py) and not bit for bit, because XLA's CPU code
takes tan from the C library (tan(30 deg) = 0.5773503, one ulp above the
correctly rounded 0.57735026 the port computes); the non-smallpt presets
are also rendered from the port's own frame at 1e-4.

Tolerances: rtol = atol = 1e-4, the reference's own bar between its two
engines (tests/test_bounce_kernel.py). smallpt is held by the reference's
statistical rule (under 5% of values off by > 0.2, image means within
1e-2): its 1e5-radius ground shells sit at the edge of float32, so last-ulp
differences of hit points flip a fraction of paths. The port and XLA's CPU
code round differently (XLA contracts a*b + c into fused multiply-adds,
rewrites 1/sqrt(x) as an approximate rsqrt and x/c as x*(1/c)); at 24x24,
4 spp, 6 bounces over seeds 7, 1, 2, 3, 4, 5, 11, 42 that flips 2.84-4.22%
of values (seed 7: 3.65%), against 2.37-3.24% between the reference's own
two engines. With the port's own frame the viewport is two ulps narrower,
every primary ray moves, and 4.51-5.90% flip (seed 7: 5.21%).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import camera as jcam
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk

PRESETS = {
    "sphere_plane": "diffuse_sphere_plane",
    "cornell": "cornell_box",
    "defocus": "defocus_blur",
    "smallpt": "smallpt_spheres",
    "mesh": "mesh_showcase",
}
SMALLPT_FRAC = 0.05


def _reference_frame(jcamera, aspect_ratio):
    """The reference's camera frame, derived under jit as render_pass does,
    as the port's CameraFrame."""
    jf = jax.jit(jcam.derive, static_argnums=1)(jcamera, aspect_ratio)
    return tcam.CameraFrame(**{f: torch.from_numpy(np.array(getattr(jf, f)))
                               for f in jf._fields})


def _render_both(preset, cfg_kw, seed, samples):
    """(reference, port from the reference's frame, port's own render_pass)."""
    jscene, jcamera = getattr(jpresets, preset)()
    ref = np.asarray(jintegrator.render_pass(
        jfinalize(jscene, use_bvh=False), jcamera, jax.random.key(seed),
        JConfig(**cfg_kw), samples))
    tscene, tcamera = getattr(tpresets, preset)()
    tscene = finalize(tscene, use_bvh=False)
    cfg = RenderConfig(**cfg_kw)
    out = bk.render_samples(
        tscene.packed, _reference_frame(jcamera, cfg.aspect_ratio),
        threefry.split(threefry.key(seed), samples), cfg, device="cpu",
    ).reshape(cfg.height, cfg.width, 3).numpy()
    own = integrator.render_pass(tscene, tcamera, threefry.key(seed), cfg,
                                 samples, device="cpu").numpy()
    return ref, out, own


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_plain_k1_matches_reference(name):
    cfg = dict(width=24, height=24, spp=4, bounces=6, spp_per_pass=4)
    ref, out, own = _render_both(PRESETS[name], cfg, 7, 4)
    assert out.shape == own.shape == (24, 24, 3)
    assert np.isfinite(out).all() and np.isfinite(own).all()
    if name == "smallpt":
        diff = np.abs(out - ref)
        assert (diff > 0.2).mean() < SMALLPT_FRAC, f"{(diff > 0.2).mean():.2%} off"
        np.testing.assert_allclose(out.mean(), ref.mean(), rtol=1e-2)
        np.testing.assert_allclose(own.mean(), ref.mean(), rtol=1e-2)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(own, ref, rtol=1e-4, atol=1e-4)


def test_plain_k1_russian_roulette_matches_reference():
    cfg = dict(width=16, height=16, spp=4, bounces=8, spp_per_pass=4,
               russian_roulette=True, rr_start_bounce=2)
    ref, out, own = _render_both("cornell_box", cfg, 3, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(own, ref, rtol=1e-4, atol=1e-4)


def test_plain_k1_black_background_matches_reference():
    cfg = dict(width=16, height=16, spp=2, bounces=4, spp_per_pass=2,
               sky_background=False)
    ref, out, own = _render_both("cornell_box", cfg, 1, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(own, ref, rtol=1e-4, atol=1e-4)


def test_render_samples_pixel_ids_slice_the_image():
    """A render of a pixel-id subset equals those pixels of the full render
    (the RNG is a function of the global pixel id)."""
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=12, height=10, spp=2, bounces=4)
    frame = tcam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.key(5), 2)
    full = bk.render_samples(scene.packed, frame, words, cfg, device="cpu")
    ids = torch.tensor([0, 7, 33, 119, 64], dtype=torch.int32)
    part = bk.render_samples(scene.packed, frame, words, cfg, pixel_ids=ids,
                             device="cpu")
    np.testing.assert_array_equal(part.numpy(), full[ids.long()].numpy())


def test_cpu_tensors_take_the_plain_version():
    scene, camera = tpresets.diffuse_sphere_plane()
    scene = finalize(scene)
    cfg = RenderConfig(width=8, height=8, spp=1, bounces=2)
    frame = tcam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.key(0), 1)
    before = bk.KERNEL_LAUNCHES
    a = bk.render_samples(scene.packed, frame, words, cfg, device="cpu")
    b = bk.render_samples_reference(scene.packed, frame, words, cfg)
    assert bk.KERNEL_LAUNCHES == before
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _uneven_inputs(samples, bounces=10):
    """K1's inputs on Cornell with Russian roulette from bounce 2 and the sky
    off, where path lengths are most uneven, on the CPU."""
    scene, camera = tpresets.cornell_box()
    cfg = RenderConfig(width=12, height=10, spp=samples, bounces=bounces,
                       russian_roulette=True, rr_start_bounce=2,
                       sky_background=False)
    return bk.render_inputs(finalize(scene).packed, tcam.derive(camera, 1.0),
                            threefry.split(threefry.key(4), samples), cfg,
                            device="cpu")


def test_plain_k1_sums_samples_in_order():
    """A pixel's radiance is the float32 sum of its samples' paths in sample
    order, ((s0 + s1) + s2) + s3, bit for bit: the order K1 keeps when a lane
    regenerates its next sample as soon as its path ends."""
    inp = _uneven_inputs(4)
    total = bk.render_reference(inp)
    acc = torch.zeros_like(total)
    for s in range(4):
        one = dataclasses.replace(inp, words=inp.words[s:s + 1])
        acc = acc + bk.render_reference(one)
    np.testing.assert_array_equal(total.numpy(), acc.numpy())


def test_plain_k1_path_lengths_are_uneven():
    """On that configuration some paths end at their first bounce and some
    run all ten (the plain version's bounce count), so a warp that ran
    each sample to its longest path would idle most of its lanes."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work

    counts = []
    for bounces in (1, 10):
        work.reset()
        bk.render_reference(_uneven_inputs(2, bounces))
        counts.append(work.WORK["bounces"])
    paths = 12 * 10 * 2
    assert counts[0] == paths
    assert paths < counts[1] < 0.5 * 10 * paths


def test_plain_k1_without_bounces_is_black():
    """bounces = 0 renders zeros (the kernel's step loop never runs)."""
    out = bk.render_reference(_uneven_inputs(2, bounces=0))
    assert out.shape == (120, 3) and not out.any()


def _small_inputs(device="cpu"):
    scene, camera = tpresets.cornell_box()
    cfg = RenderConfig(width=4, height=4, spp=1, bounces=2)
    return bk.render_inputs(finalize(scene).packed, tcam.derive(camera, 1.0),
                            threefry.split(threefry.key(0), 1), cfg,
                            device=device)


def test_launch_checks_its_inputs():
    inp = _small_inputs()
    bad = dataclasses.replace(inp, pid=inp.pid.to(torch.int64))
    with pytest.raises(ValueError, match="K1 input"):
        bk._launch(bad)
    bad = dataclasses.replace(inp, scene=inp.scene[:-1])
    with pytest.raises(ValueError, match="K1 input"):
        bk._launch(bad)


def test_launch_without_nvcc_raises(tmp_path, monkeypatch):
    """The kernel path never falls back: without a CUDA toolkit the build
    raises instead of rendering."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    if build.shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    before = bk.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bk._launch(_small_inputs())
    assert bk.KERNEL_LAUNCHES == before
