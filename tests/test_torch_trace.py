"""The port's spans (utils/timing.span) on the CPU: without a profiler a
span is one shared no-op and never reaches torch.profiler's
record_function; under torch.profiler each route of `integrator.render`
emits its spans, nested as the benchmark's readers expect, once an image
and once a sort, with the plain K1, K3 and K4 versions.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.utils import timing

SPANS = {"integrator.render", "integrator.prep", "k1.prep", "wavefront.prep",
         "wavefront.sort", "host.read", "wavefront.bounce", "k3.intersect",
         "k4.worklist", "k4.winner", "wavefront.unsort"}
WAVEFRONT = {"wavefront.prep", "wavefront.sort", "wavefront.bounce",
             "wavefront.unsort"}
IMAGES = 2


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    mesh, mesh_cam = presets.mesh_showcase(16, 32)
    cornell, cornell_cam = presets.cornell_box()
    cache = str(tmp_path_factory.mktemp("bvh_cache"))
    return {"mesh": (finalize(mesh, bvh_cache_dir=cache), mesh_cam),
            "k1": (finalize(cornell), cornell_cam)}


# route -> (scene, RenderConfig keywords): a tile-BVH scene through the
# sorted wavefront (K3, work lists, K4), the Cornell box through K1, and
# the Cornell box through the differentiable wavefront (K3 alone).
ROUTES = {
    "mesh": ("mesh", dict(width=8, height=8, spp=1, bounces=3)),
    "k1": ("k1", dict(width=8, height=8, spp=2, bounces=3)),
    "wavefront": ("k1", dict(width=8, height=8, spp=1, bounces=3,
                             fused_bounce=False)),
}


def _render(scenes, route):
    name, kw = ROUTES[route]
    scene, camera = scenes[name]
    return integrator.render(scene, camera, RenderConfig(**kw), device="cpu")


def _span_tree(prof):
    """(count of each span, {span: the names of the spans it lies in}),
    the parents found through the profiler's own nesting."""
    counts = collections.Counter()
    parents = collections.defaultdict(set)
    for e in prof.events():
        if e.name not in SPANS:
            continue
        counts[e.name] += 1
        p = e.cpu_parent
        while p is not None and p.name not in SPANS:
            p = p.cpu_parent
        parents[e.name].add(p.name if p is not None else None)
    return counts, dict(parents)


@pytest.mark.parametrize("route", ["mesh", "k1"])
def test_span_without_a_profiler_is_a_shared_noop(scenes, route, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    assert timing.span("integrator.render") is timing.span("host.read")
    with timing.span("a") as a, timing.span("b") as b:
        assert a is None and b is None
    film = _render(scenes, route)
    assert float(film.accum.sum()) > 0


# route -> (spans an image, {span: the span it lies in}). A 1-pass,
# 3-bounce render sorts before bounces 1 and 2: two live counts read.
EXPECTED = {
    "mesh": ({"integrator.render": 1, "integrator.prep": 1, "wavefront.prep": 2,
              "wavefront.sort": 2, "host.read": 2, "wavefront.bounce": 3,
              "k3.intersect": 3, "k4.worklist": 3, "k4.winner": 3,
              "wavefront.unsort": 1},
             {"integrator.render": None, "integrator.prep": "integrator.render",
              "wavefront.prep": "integrator.render",
              "wavefront.sort": "integrator.render", "host.read": "wavefront.sort",
              "wavefront.bounce": "integrator.render",
              "k3.intersect": "wavefront.bounce", "k4.worklist": "wavefront.bounce",
              "k4.winner": "wavefront.bounce",
              "wavefront.unsort": "integrator.render"}),
    "k1": ({"integrator.render": 1, "integrator.prep": 1, "k1.prep": 1},
           {"integrator.render": None, "integrator.prep": "integrator.render",
            "k1.prep": "integrator.render"}),
    "wavefront": ({"integrator.render": 1, "integrator.prep": 1, "host.read": 2,
                   "k3.intersect": 3},
                  {"integrator.render": None, "integrator.prep": "integrator.render",
                   "host.read": "integrator.render",
                   "k3.intersect": "integrator.render"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_render_spans_nest_once_an_image(scenes, route):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(IMAGES):
            _render(scenes, route)
    counts, parents = _span_tree(prof)
    per_image, nesting = EXPECTED[route]
    assert dict(counts) == {k: v * IMAGES for k, v in per_image.items()}
    assert parents == {k: {v} for k, v in nesting.items()}
    if route != "mesh":
        assert not WAVEFRONT & set(counts)
