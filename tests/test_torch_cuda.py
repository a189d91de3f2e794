"""K1 against its plain version on a CUDA card. These tests skip without a
card. The file imports no jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk

PRESETS = ["diffuse_sphere_plane", "cornell_box", "defocus_blur",
           "smallpt_spheres", "mesh_showcase"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is compiled and run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
def test_k1_matches_plain_on_card(preset, cuda_device):
    scene, camera = getattr(tpresets, preset)()
    scene = finalize(scene, use_bvh=False)
    cfg = RenderConfig(width=64, height=64, spp=4, bounces=6, spp_per_pass=4)
    inp = bk.render_inputs(scene.packed, tcam.derive(camera, 1.0),
                           threefry.split(threefry.key(7), 4), cfg,
                           device=cuda_device)
    before = bk.KERNEL_LAUNCHES
    k1 = bk.render_kernel(inp).cpu().numpy()
    plain = bk.render_reference(inp).cpu().numpy()
    assert bk.KERNEL_LAUNCHES == before + 1
    if preset == "smallpt_spheres":
        assert (np.abs(k1 - plain) > 0.2).mean() < 0.05
    else:
        np.testing.assert_allclose(k1, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=24, height=16, spp=4, bounces=6, spp_per_pass=2,
                       russian_roulette=True, rr_start_bounce=2)
    before = bk.KERNEL_LAUNCHES
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert bk.KERNEL_LAUNCHES == before + 2  # one launch per pass
    cpu = integrator.render(scene, camera, cfg, device="cpu")
    np.testing.assert_allclose(card.accum.cpu().numpy(), cpu.accum.numpy(),
                               rtol=1e-4, atol=1e-4)
