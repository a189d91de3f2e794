"""The whole mesh slice on the CPU: the port's tile-BVH render of
mesh_showcase against the JAX reference's render, sorted against unsorted,
and the tile-BVH render against the port's brute-force K1 render.

Tolerances: against the reference rtol = atol = 1e-4 (the bar of the
port's other renders; the two round differently, see
test_torch_mesh_shading.py). Sorted, unsorted and strided renders are
bit-identical: every operation is row-independent and the random draws
follow the ray. Tile-BVH against brute force is held to the reference's
own bar between those engines (tests/test_mesh_bvh_e2e.py:51-52): under
1% of values off by more than 1e-3, since the two engines round apart
(K1 shades in its own order, and merges parallelogram pairs into quads).
"""

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu_torch import cli
from raytracingthenextweekcuda_tpu_torch.apps import bench, bench_scenes
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3

CFG = dict(width=24, height=24, spp=4, bounces=4, spp_per_pass=4)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    scene, camera = presets.mesh_showcase(16, 32)
    cache = str(tmp_path_factory.mktemp("bvh_cache"))
    return finalize(scene, bvh_cache_dir=cache), camera


def _reference(cfg_kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTNW_BVH_CACHE", "")
        scene, camera = jpresets.mesh_showcase(16, 32)
        return np.asarray(jintegrator.render(jfinalize(scene), camera,
                                             JConfig(**cfg_kw)).accum)


def _render(scene, camera, **kw):
    return integrator.render(scene, camera, RenderConfig(**kw),
                             device="cpu").accum.numpy()


@pytest.mark.parametrize("extra", [{}, dict(russian_roulette=True, rr_start_bounce=2,
                                            sky_background=False, bounces=5)],
                         ids=["default", "rr_nosky"])
def test_mesh_render_matches_reference(mesh, extra):
    scene, camera = mesh
    assert scene.packed.leaf_bounds is not None  # 960 triangles: tile-BVH
    kw = {**CFG, **extra}
    before = (bk.KERNEL_LAUNCHES, k3.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES)
    out = _render(scene, camera, **kw)
    assert (bk.KERNEL_LAUNCHES, k3.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES) == before
    ref = _reference(kw)
    assert out.shape == (24, 24, 3) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.mean(), ref.mean(), rtol=1e-3)


def test_sorted_unsorted_and_strided_renders_bit_identical(mesh):
    scene, camera = mesh
    kw = dict(CFG, bounces=6)
    base = _render(scene, camera, **kw)
    assert base.mean() > 0.1
    np.testing.assert_array_equal(base, _render(scene, camera, **kw, sort_rays=False))
    np.testing.assert_array_equal(base, _render(scene, camera, **kw, sort_stride=2))


def test_tile_bvh_render_matches_brute_force(mesh):
    scene, camera = mesh
    brute = finalize(presets.mesh_showcase(16, 32)[0], use_bvh=False)
    assert brute.packed.leaf_bounds is None
    cfg = RenderConfig(**CFG)
    a = integrator.render(scene, camera, cfg, device="cpu").mean.numpy()
    b = integrator.render(brute, camera, cfg, device="cpu").mean.numpy()
    diff = np.abs(a - b)
    print(f"tile-BVH vs brute: {(diff > 1e-3).mean():.4%} of values off by > 1e-3")
    assert (diff > 1e-3).mean() < 0.01
    np.testing.assert_allclose(a.mean(), b.mean(), atol=1e-3)


def test_bench_scenes_carry_their_asset():
    for make, tris in ((bench_scenes.published_mesh_scene, 960),
                       (bench_scenes.stress_mesh_scene, 16128)):
        scene, _, asset = make()
        assert scene.triangles.count == tris and "stand-in" in asset


def test_mesh_bench_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.run_mesh_bench(width=8, height=8, spp=1, bounces=1, spp_per_pass=1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", "--mesh", "--width", "8", "--height", "8", "--spp", "1"])


def test_tile_bvh_scene_on_cuda_without_cuda_raises(mesh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera = mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        integrator.render(scene, camera, RenderConfig(**CFG), device="cuda")


def test_sample_groups_follow_the_wavefront_cap(mesh, monkeypatch):
    """A pass traced as several multi-sample wavefronts (here one sample
    each) gives the same image as one wavefront of all its samples."""
    scene, camera = mesh
    base = _render(scene, camera, **CFG)
    monkeypatch.setattr(integrator, "_SORT_WAVEFRONT_CAP", 24 * 24)
    np.testing.assert_array_equal(base, _render(scene, camera, **CFG))
