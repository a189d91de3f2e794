"""The port's camera frame, primary rays and film tonemap against the JAX
reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingthenextweekcuda_tpu.models import camera as jcam
from raytracingthenextweekcuda_tpu.models import film as jfilm
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.ops.pallas.bounce_kernel import _pack_frame
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import film as tfilm
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.ops import threefry

PRESETS = ["diffuse_sphere_plane", "cornell_box", "defocus_blur",
           "smallpt_spheres", "mesh_showcase"]


def _np_camera(camera):
    return {f: np.asarray(getattr(camera, f)) for f in camera._fields}


@pytest.mark.parametrize("preset", PRESETS)
def test_derive_and_pack_frame(preset):
    _, jc = getattr(jpresets, preset)()
    _, tc = getattr(tpresets, preset)()
    for aspect in (1.0, 1.5):
        ref = jcam.derive(jc, aspect)
        out = tcam.derive(tc, aspect)
        for f in ref._fields:
            np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                       getattr(out, f).numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(np.asarray(_pack_frame(ref)),
                                   tcam.pack_frame(out).numpy(),
                                   rtol=1e-6, atol=1e-6)
    # A camera carried across from the reference's leaves derives the same.
    fromnp = tcam.derive(tcam.Camera.from_numpy(_np_camera(jc)), 1.0)
    np.testing.assert_array_equal(tcam.pack_frame(fromnp).numpy(),
                                  tcam.pack_frame(tcam.derive(tc, 1.0)).numpy())


def test_raygen_matches_generate_rays_with_lens():
    _, jc = jpresets.defocus_blur()
    _, tc = tpresets.defocus_blur()
    jc = jc._replace(aperture=jnp.float32(0.4))
    tc = tcam.Camera.from_numpy({**_np_camera(jc), "aperture": 0.4})
    width, height = 40, 24
    key = jax.random.key(11)
    rays, _ = jcam.generate_rays(jcam.derive(jc, width / height), key,
                                 width, height)
    words = threefry.key(11)
    frame = tcam.pack_frame(tcam.derive(tc, width / height))
    pid = torch.arange(width * height, dtype=torch.int64)
    ox, oy, oz, dx, dy, dz, tm = tcam.raygen(pid, int(words[0]), int(words[1]),
                                             frame, width, height)
    origin = np.asarray(rays.origin)
    assert np.abs(origin - origin.mean(0)).max() > 1e-3  # the lens is open
    np.testing.assert_allclose(origin, torch.stack([ox, oy, oz], -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rays.direction),
                               torch.stack([dx, dy, dz], -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rays.time), tm.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_generate_rays_multi_matches_reference():
    """Multi-sample raygen (sample-major) against the reference at 1e-6, its
    per-ray key words bit-equal, and each sample's slice equal to that
    sample's own context (ray_context + generate_rays_ctx) bit for bit."""
    from raytracingthenextweekcuda_tpu.ops import rng as jrng

    _, jc = jpresets.defocus_blur()
    jc = jc._replace(aperture=jnp.float32(0.4))
    tc = tcam.Camera.from_numpy({**_np_camera(jc), "aperture": 0.4})
    width, height, g = 20, 12, 3
    keys = jax.random.split(jax.random.key(5), g)
    words = threefry.split(threefry.key(5), g)
    jrays, jctx = jcam.generate_rays_multi(jcam.derive(jc, width / height), keys,
                                           width, height)
    frame = tcam.derive(tc, width / height)
    rays, ctx = tcam.generate_rays_multi(frame, words, width, height)
    for a, b in ((jrays.origin, rays.origin), (jrays.direction, rays.direction),
                 (jrays.time, rays.time)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6)
    for a, b in zip(jctx, ctx):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    np.testing.assert_array_equal(np.asarray(jrng.key_bases(keys)[0]).astype(np.int64),
                                  ctx.base0[::width * height].numpy())
    n = width * height
    for s in range(g):
        pid = torch.arange(n, dtype=torch.int64)
        one = tcam.generate_rays_ctx(frame, tcam.ray_context(words[s], pid),
                                     width, height)
        np.testing.assert_array_equal(one.origin.numpy(),
                                      rays.origin[s * n:(s + 1) * n].numpy())
        np.testing.assert_array_equal(one.direction.numpy(),
                                      rays.direction[s * n:(s + 1) * n].numpy())


@pytest.mark.parametrize("count", [1, 3, 7])
def test_tonemap_and_to_image_bit_equal(count):
    r = np.random.default_rng(count)
    accum = (r.random((6, 9, 3)) * 3.0 * count - 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jfilm.tonemap_u8(jnp.asarray(accum))),
        tfilm.tonemap_u8(torch.from_numpy(accum)).numpy())
    ref = jfilm.Film(jnp.asarray(accum), jnp.int32(count))
    out = tfilm.Film(torch.from_numpy(accum), count)
    np.testing.assert_array_equal(jfilm.to_image(ref), tfilm.to_image(out))


def test_film_accumulates():
    film = tfilm.Film.create(4, 2)
    film = film.add(torch.ones((2, 4, 3)), 2).add(torch.full((2, 4, 3), 3.0), 2)
    assert film.sample_count == 4
    np.testing.assert_array_equal(film.mean.numpy(), np.ones((2, 4, 3)))
