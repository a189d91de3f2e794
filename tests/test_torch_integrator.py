"""The port's offline render against the JAX reference through each of its
engines, its device rules, and that the port package never imports JAX,
the JAX package or PyYAML."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu_torch import cli
from raytracingthenextweekcuda_tpu_torch.apps import bench
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.io.image import read_png
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.cuda.launch import LAUNCHES

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "raytracingthenextweekcuda_tpu_torch"
CFG = dict(width=16, height=16, spp=4, bounces=6, spp_per_pass=2)


@pytest.fixture(scope="module")
def jax_cornell_film():
    scene, camera = jpresets.cornell_box()
    return jintegrator.render(jfinalize(scene), camera, JConfig(**CFG))


@pytest.fixture(scope="module")
def cornell():
    scene, camera = presets.cornell_box()
    return finalize(scene), camera


def test_render_matches_reference(jax_cornell_film, cornell):
    scene, camera = cornell
    cfg = RenderConfig(**CFG)
    assert cfg.passes() == [2, 2]
    before = LAUNCHES["K1"]
    film = integrator.render(scene, camera, cfg, device="cpu")
    assert LAUNCHES["K1"] == before  # CPU tensors: the plain version
    assert film.sample_count == int(jax_cornell_film.sample_count) == 4
    np.testing.assert_allclose(film.accum.numpy(),
                               np.asarray(jax_cornell_film.accum),
                               rtol=1e-4, atol=1e-4)


def test_cuda_request_without_cuda_raises(cornell, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera = cornell
    before = LAUNCHES["K1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        integrator.render(scene, camera, RenderConfig(**CFG), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.run_bench(width=8, height=8, spp=1, bounces=1, spp_per_pass=1,
                        device="cuda")
    assert LAUNCHES["K1"] == before


def test_entry_points_default_to_cuda(cornell, monkeypatch):
    """Every public entry point renders on the card unless asked for the
    CPU, so without CUDA a call that names no device raises."""
    from raytracingthenextweekcuda_tpu_torch.apps import fit
    from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
    from raytracingthenextweekcuda_tpu_torch.ops import threefry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera = cornell
    cfg = RenderConfig(**CFG)
    frame = tcam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.key(0), 1)
    calls = [
        lambda: integrator.render(scene, camera, cfg),
        lambda: integrator.render_pass(scene, camera, threefry.key(0), cfg, 1),
        lambda: integrator.render_gbuffer(scene, camera, threefry.key(0), cfg, 1),
        lambda: fit.run_fit(steps=1, verbose=False),
        lambda: fit.run_fit_mesh(steps=1, verbose=False),
        lambda: bk.render_samples(scene.packed, frame, words, cfg),
        lambda: bk.render_inputs(scene.packed, frame, words, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_differentiable_wavefront_matches_reference(jax_cornell_film, cornell):
    """fused_bounce=False on a finalized scene: the torch wavefront over K3,
    per sample, gives the reference's image (and so K1's)."""
    scene, camera = cornell
    before = LAUNCHES["K1"]
    film = integrator.render(scene, camera, RenderConfig(**CFG, fused_bounce=False),
                             device="cpu")
    assert LAUNCHES["K1"] == before
    np.testing.assert_allclose(film.accum.numpy(),
                               np.asarray(jax_cornell_film.accum),
                               rtol=1e-4, atol=1e-4)


def test_unfinalized_scene_matches_reference():
    """An unpacked scene renders through the plain torch intersects."""
    kw = dict(width=12, height=12, spp=2, bounces=4, spp_per_pass=2)
    jscene, jcamera = jpresets.defocus_blur()
    scene, camera = presets.defocus_blur()
    ref = jintegrator.render(jscene, jcamera, JConfig(**kw))
    film = integrator.render(scene, camera, RenderConfig(**kw), device="cpu")
    np.testing.assert_allclose(film.accum.numpy(), np.asarray(ref.accum),
                               rtol=1e-4, atol=1e-4)


def test_cli_render_mesh_takes_the_tile_bvh(tmp_path, monkeypatch):
    """`render --preset mesh` finalizes with the automatic choice, so its
    2,208 triangles go to the sorted wavefront over a tile-BVH."""
    seen = []
    sorted_pass = integrator._render_pass_sorted

    def spy(scene, *args, **kw):
        seen.append(scene.packed.leaf_bounds is not None)
        return sorted_pass(scene, *args, **kw)

    monkeypatch.setattr(integrator, "_render_pass_sorted", spy)
    out = tmp_path / "m.png"
    assert cli.main(["render", "--preset", "mesh", "--width", "6", "--height",
                     "4", "--spp", "1", "--bounces", "2", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert seen == [True]
    assert read_png(str(out)).shape == (4, 6, 3)


def test_cli_render_writes_png(tmp_path):
    out = tmp_path / "r.png"
    assert cli.main(["render", "--preset", "cornell", "--width", "8",
                     "--height", "6", "--spp", "1", "--bounces", "2",
                     "--device", "cpu", "--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (6, 8, 3) and img.max() > 0


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}: imports {name}"
        assert top != "raytracingthenextweekcuda_tpu", f"{path}: imports {name}"
        # The H100 host has no PyYAML: scene files go through io/yaml_subset.
        assert top != "yaml", f"{path}: imports {name}"
