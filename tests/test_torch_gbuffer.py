"""The port's G-buffer render and its one-sample raygen against the JAX
reference.

`render_gbuffer` is held against the reference's on a finalized Cornell box
(primary hits through K3's plain version, radiance through K2's plain
version or the torch wavefront) and on the unfinalized diffuse_sphere_plane
(the plain torch intersects), with `fused_bounce` True and False: every AOV
at rtol = atol = 1e-4, and the hit mask exactly. The reference runs its
Pallas kernels in interpret mode on the CPU.
"""

import numpy as np
import pytest
import torch

import jax

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk

AOVS = ("radiance", "depth", "normal", "albedo", "hit_mask")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "wavefront"])
@pytest.mark.parametrize("preset,packed,size", [
    ("cornell_box", True, 16),
    ("diffuse_sphere_plane", False, 24),
], ids=["cornell_finalized", "sphere_plane_unfinalized"])
def test_gbuffer_matches_reference(preset, packed, size, fused):
    kw = dict(width=size, height=size, spp=2, bounces=4, fused_bounce=fused)
    jscene, jcamera = getattr(jpresets, preset)()
    tscene, tcamera = getattr(presets, preset)()
    if packed:
        jscene, tscene = jfinalize(jscene), finalize(tscene)
    ref = jintegrator.render_gbuffer(jscene, jcamera, jax.random.key(4),
                                     JConfig(**kw), 2)
    before = bk.PATH_LAUNCHES
    out = integrator.render_gbuffer(tscene, tcamera, threefry.key(4),
                                    RenderConfig(**kw), 2, device="cpu")
    assert bk.PATH_LAUNCHES == before  # CPU tensors: the plain version
    assert set(out) == set(AOVS)
    for name in AOVS:
        a, b = np.asarray(ref[name]), out[name].numpy()
        assert a.shape == b.shape, name
        assert np.isfinite(b).all(), name
        if name == "hit_mask":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=name)
    mask = out["hit_mask"].numpy()
    assert 0.2 < mask.mean() and (out["depth"].numpy()[mask > 0.99] > 0).all()


def test_gbuffer_radiance_equals_render_pass():
    """K2 on each sample's wavefront sums to K1's pass: the same stream."""
    scene, camera = presets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=12, height=12, spp=2, bounces=5)
    key = threefry.key(6)
    g = integrator.render_gbuffer(scene, camera, key, cfg, 2, device="cpu")
    np.testing.assert_array_equal(
        g["radiance"].numpy(),
        integrator.render_pass(scene, camera, key, cfg, 2, device="cpu").numpy())


def test_generate_rays_is_a_group_of_one():
    _, camera = presets.defocus_blur()
    frame = tcam.derive(camera, 1.5)
    words = threefry.split(threefry.key(3), 2)
    rays, ctx = tcam.generate_rays(frame, words[1], 9, 6)
    multi, mctx = tcam.generate_rays_multi(frame, words[1:2], 9, 6)
    for f in ("origin", "direction", "time"):
        assert torch.equal(getattr(rays, f), getattr(multi, f)), f
    assert isinstance(ctx.base0, int) and isinstance(ctx.base1, int)
    assert torch.equal(ctx.pixel_id, mctx.pixel_id)
    assert (ctx.base0, ctx.base1) == (int(mctx.base0[0]), int(mctx.base1[0]))
    ids = torch.tensor([0, 7, 30, 53])
    some, sctx = tcam.generate_rays(frame, words[1], 9, 6, pixel_ids=ids)
    for f in ("origin", "direction", "time"):
        assert torch.equal(getattr(some, f), getattr(rays, f)[ids]), f
    assert torch.equal(sctx.pixel_id, ids)
