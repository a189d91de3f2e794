"""The port's offline render against the JAX reference, its device rules,
what it refuses, and that the port package never imports JAX."""

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
    before = bk.KERNEL_LAUNCHES
    film = integrator.render(scene, camera, cfg, device="cpu")
    assert bk.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert film.sample_count == int(jax_cornell_film.sample_count) == 4
    np.testing.assert_allclose(film.accum.numpy(),
                               np.asarray(jax_cornell_film.accum),
                               rtol=1e-4, atol=1e-4)


def test_cuda_request_without_cuda_raises(cornell, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera = cornell
    before = bk.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        integrator.render(scene, camera, RenderConfig(**CFG), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.run_bench(width=8, height=8, spp=1, bounces=1, spp_per_pass=1,
                        device="cuda")
    assert bk.KERNEL_LAUNCHES == before


def test_ineligible_scenes_raise(cornell):
    scene, camera = cornell
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        integrator.render(scene, camera, RenderConfig(**CFG, fused_bounce=False))
    unpacked, _ = presets.cornell_box()
    with pytest.raises(NotImplementedError, match="finalize"):
        integrator.render(unpacked, camera, RenderConfig(**CFG))


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
