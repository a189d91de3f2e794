"""The `materialball_x48` configuration (benchmark/configs/materialball_x48)
and the work lists' packet-frustum pass that CPU tensors take past 2,048
leaves, as the JAX package does (on the card the work-list kernel builds
them: tests/test_torch_cuda.py), at a small size on the CPU.

The configuration's data against its rule: the 48 offsets drawn again from
numpy's default_rng(7) as the repository's large-scene job lays out its
balls, the triangles counted from the primitives' parameters without
building them, and tools/materialball_config.py writing the file as it is.
A small version of the deployment (4 copies of a 16 x 32 ball, scaled and
offset as the configuration's first four, in the same box) renders
through `integrator.render` on the CPU with FRUSTUM_LEAF_THRESHOLD at 0,
so that the frustum pass builds every work list: the image equals the
exact pass's bit for bit, the pass counts its (block, leaf) pairs, and its
span `k4.frustum` lies in `k4.worklist` once a bounce.
"""

import collections
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program, scenedata
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
from raytracingthenextweekcuda_tpu_torch.ops.cuda import work

CONFIG = "materialball_x48"
TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "materialball_config.py"
RENDER = dict(width=16, height=16, spp=2, bounces=5, spp_per_pass=2)


def _balls(cfg):
    return [p for p in cfg["scene"]["primitives"]
            if p["type"] == "mesh" and p["generator"] == "uv_sphere"]


def _small_config() -> dict:
    """The configuration with its first 4 balls alone, each at 16 x 32 in
    place of 113 x 209, scaled and offset as in the file."""
    cfg = scenedata.load_config(CONFIG)
    balls = _balls(cfg)
    for b in balls[:4]:
        b["params"].update(n_lat=16, n_lon=32)
    cfg["scene"]["primitives"] = [p for p in cfg["scene"]["primitives"]
                                  if p not in balls] + balls[:4]
    return cfg


def _triangles(prim) -> int:
    if prim["generator"] == "cube":
        return 12
    q = prim["params"]
    return (2 * q["n_lat"] - 2) * q["n_lon"]


def test_offsets_follow_the_layout_rule():
    """Copy i sits at grid cell (i % 7, i // 7) with z jitter 0.35 U(-1, 1)
    from default_rng(7), and the rule's move by (0, 0, -1) before the 0.45
    scale adds -0.45 to z; all in float32."""
    balls = _balls(scenedata.load_config(CONFIG))
    assert len(balls) == 48
    rng = np.random.default_rng(7)
    grid = math.ceil(math.sqrt(48))
    for i, ball in enumerate(balls):
        gx, gy = i % grid, i // grid
        z = np.float32(0.35 * rng.uniform(-1.0, 1.0))
        want = np.float32([-0.6 + 1.2 * gx / (grid - 1),
                           -0.25 + 0.5 * gy / (grid - 1), z - np.float32(0.45)])
        assert np.array_equal(np.float32(ball["transform"]["offset"]), want), i
        assert ball["transform"]["scale"] == [0.45, 0.45, 0.45]
        assert "rotate_y" not in ball["transform"]
        assert ball["params"] == {"radius": 1.0, "center": [0.0, 0.0, 0.0],
                                  "n_lat": 113, "n_lon": 209}
        assert ball["material"] == 20


def test_triangles_counted_from_the_parameters():
    """2,247,192 triangles: 48 balls of 46,816 and the two 12-triangle
    boxes; everything but the balls is the mesh_stress scene."""
    cfg = scenedata.load_config(CONFIG)
    prims = cfg["scene"]["primitives"]
    assert sum(_triangles(p) for p in prims if p["type"] == "mesh") \
        == cfg["triangles"] == 2247192
    assert sum(_triangles(p) for p in _balls(cfg)) \
        == cfg["published"]["triangles"] == 48 * 46816
    assert cfg["published"]["copies"] == 48 and cfg["reduced"] == []
    base = scenedata.load_config("mesh_stress")["scene"]
    assert cfg["scene"]["camera"] == base["camera"]
    assert cfg["scene"]["materials"] == base["materials"]
    assert [p for p in prims if p not in _balls(cfg)] == \
        [p for p in base["primitives"] if p["generator" if p["type"] == "mesh"
                                            else "type"] != "uv_sphere"]


def test_tool_writes_the_committed_config():
    spec = importlib.util.spec_from_file_location("materialball_config", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.config_text() == scenedata.config_path(CONFIG).read_text()


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The deployment at a small size: the configuration's first 4 balls at
    16 x 32, in the same box, finalized to a tile-BVH."""
    scene, camera = program.build_scene(_small_config())
    cache = str(tmp_path_factory.mktemp("bvh_cache"))
    return finalize(scene, bvh_cache_dir=cache), camera


def _render(small, frustum, monkeypatch, **kw):
    scene, camera = small
    if frustum:
        monkeypatch.setattr(k4, "FRUSTUM_LEAF_THRESHOLD", 0)
    work.reset()
    cfg = RenderConfig(**{**RENDER, **kw})
    film = integrator.render(scene, camera, cfg, device="cpu")
    monkeypatch.undo()
    return film.accum, work.WORK["frustum_pairs"]


def test_frustum_route_equals_exact_route(small, monkeypatch):
    """The frustum pass's superset lists change which leaves K4 walks,
    never a winner: the image is the exact pass's bit for bit. The pass
    counts blocks x leaves of every build; the exact pass counts none."""
    scene, _ = small
    assert int((scene.triangles.mesh_id >= 0).sum()) == 24 + 4 * 960
    n_leaves = scene.packed.leaf_bounds.shape[1]
    assert n_leaves > 1 and not k4.use_frustum_worklist(n_leaves)
    exact, pairs_exact = _render(small, False, monkeypatch)
    frustum, pairs = _render(small, True, monkeypatch)
    assert pairs_exact == 0
    blocks = -(-RENDER["width"] * RENDER["height"] * RENDER["spp"] // k4.BLOCK)
    assert blocks * n_leaves <= pairs <= RENDER["bounces"] * blocks * n_leaves
    assert float(exact.sum()) > 0
    assert torch.equal(frustum, exact)


def test_frustum_span_once_a_bounce(small, monkeypatch):
    """Under torch.profiler, `k4.frustum` lies in `k4.worklist`, once in
    each of the render's work-list builds, one a bounce."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(small, True, monkeypatch, width=8, height=8, spp=1, spp_per_pass=1,
                bounces=3)
    counts, parents = collections.Counter(), set()
    for e in prof.events():
        if e.name in ("k4.frustum", "k4.worklist", "wavefront.bounce"):
            counts[e.name] += 1
        if e.name == "k4.frustum":
            parents.add(e.cpu_parent.name if e.cpu_parent else None)
    assert counts["k4.frustum"] == counts["k4.worklist"] == counts["wavefront.bounce"]
    assert counts["k4.frustum"] >= 2
    assert parents == {"k4.worklist"}
