"""The span readers on synthetic traces: idle time while the host is
inside named spans (nesting, a gap across a span's edge, the window's
edges), device operations paired with their enqueue calls by order and
put down to the innermost span, no pairing on a count mismatch, a graph
launch or clocks that disagree, and every new reader's None outside its
kind or without spans.
"""

from __future__ import annotations

import types

import pytest

from benchmark import harness, spans
from benchmark.profiling import Trace

READERS = ("prep_idle_ms_per_image", "bounce_idle_ms_per_image",
           "sort_idle_ms_per_image", "host_reads_per_image",
           "worklist_ms_per_image", "bounce_torch_ms_per_image", "sort_ms_per_image")


def _trace(device, host, window=(0, 1000)):
    return Trace(jobs=1, window_ns=window, device=list(device), host=list(host))


def _ctx(trace, kind="offline"):
    return types.SimpleNamespace(kind=kind, trace=trace)


def _k(start, dur, name="k"):
    return (name, start, dur, "kernel")


def test_idle_while_inside_spans():
    # Busy [100, 200) and [500, 600) of the window [0, 1000).
    device = [_k(100, 100), _k(500, 100)]
    host = [
        ("integrator.render", 0, 1000),
        ("integrator.prep", 50, 100),     # idle [50, 100): the gap crosses its end
        ("host.read", 60, 20),            # nested: adds nothing to the union
        ("wavefront.prep", 180, 120),     # idle [200, 300)
        ("wavefront.sort", 550, 100),     # idle [600, 650)
        ("wavefront.bounce", 900, 300),   # past the window's end: idle [900, 1000)
        ("k1.prep", -200, 250),           # before the window's start: idle [0, 50)
    ]
    t = _trace(device, host)
    assert spans.idle_intervals(t) == [(0, 100), (200, 500), (600, 1000)]
    assert spans.idle_ns(t, ("integrator.prep",)) == 50
    assert spans.idle_ns(t, ("host.read",)) == 20
    assert spans.idle_ns(t, ("integrator.prep", "host.read")) == 50
    assert spans.idle_ns(t, ("wavefront.sort",)) == 50
    assert spans.idle_ns(t, ("wavefront.bounce",)) == 100
    assert spans.idle_ns(t, ("k1.prep",)) == 50
    assert spans.idle_ns(t, ("integrator.prep", "k1.prep", "wavefront.prep")) == 200
    assert spans.idle_ns(t, ("k4.worklist",)) is None
    # Whole spans in the window only, for counts: the bounce and k1.prep
    # cross its edges.
    assert spans.images(t) == 1
    assert spans.count(t, "wavefront.bounce") == 0 and spans.count(t, "host.read") == 1


def _paired_trace(extra_host=(), extra_device=()):
    """Three enqueues in a bounce: in the work-list build, in the body, in
    K4; a sort with a host read; one copy outside every span. Device
    operations listed out of order."""
    host = [
        ("integrator.render", 0, 1000),
        ("wavefront.bounce", 100, 300),
        ("k4.worklist", 110, 50),
        ("aten::mul", 115, 20),
        ("cudaLaunchKernel", 120, 5),
        ("cudaLaunchKernel", 200, 5),
        ("k4.winner", 300, 50),
        ("cudaLaunchKernel", 310, 5),
        ("wavefront.sort", 500, 200),
        ("host.read", 600, 50),
        ("cudaMemcpyAsync", 610, 5),
        ("cudaStreamSynchronize", 620, 20),
        ("wavefront.unsort", 800, 50),
        ("cudaMemsetAsync", 810, 5),
        ("cudaMemcpyAsync", 1200, 5),     # after the window
        *extra_host,
    ]
    device = [
        ("bvh_winner_kernel", 330, 40, "kernel"),
        ("slab", 130, 30, "kernel"),
        ("Memcpy DtoH", 615, 3, "gpu_memcpy"),
        ("mul", 210, 20, "kernel"),
        ("Memset", 815, 7, "gpu_memset"),
        ("Memcpy HtoD", 1210, 4, "gpu_memcpy"),
        *extra_device,
    ]
    return _trace(device, host)


def test_pairing_by_order_and_the_innermost_span():
    t = _paired_trace()
    att = spans.attribution(t)
    assert [(d, c[0] if c else None) for _, d, c in att] == [
        (30, "k4.worklist"), (20, "wavefront.bounce"), (40, "k4.winner"),
        (3, "host.read"), (7, "wavefront.unsort"), (4, None)]
    assert att[3][2] == ("host.read", "wavefront.sort", "integrator.render")
    assert spans.device_ns(t, ("k4.worklist",)) == 30
    assert spans.device_ns(t, ("wavefront.bounce",),
                           ("k3.intersect", "k4.worklist", "k4.winner")) == 20
    assert spans.device_ns(t, ("wavefront.sort", "wavefront.unsort")) == 10
    # The copy after the window is in no span and outside the window.
    assert spans.device_ns(t, ("integrator.render",)) == 100
    assert spans.device_ns(t, ("k3.intersect",)) is None


NO_PAIRING = {"count": "7 device operations against 6 enqueue calls",
              "graph": "graph launch", "clock": "the clocks disagree"}


@pytest.mark.parametrize("fault", sorted(NO_PAIRING))
def test_no_pairing_on_a_count_mismatch_a_graph_launch_or_a_clock_drift(fault, capsys):
    if fault == "count":
        t = _paired_trace(extra_device=[("lost", 900, 5, "kernel")])
    elif fault == "graph":
        t = _paired_trace(extra_host=[("cudaGraphLaunch", 900, 5)],
                          extra_device=[("replayed", 905, 5, "kernel")])
    else:  # the device's clock runs ahead: an operation before its enqueue
        slack = spans.CLOCK_SLACK_NS
        t = _paired_trace(extra_host=[("cudaLaunchKernel", 900 + 2 * slack, 5)],
                          extra_device=[("early", 900 + slack - 1, 5, "kernel")])
    assert spans.attribution(t) is None
    assert spans.device_ns(t, ("k4.worklist",)) is None
    assert NO_PAIRING[fault] in capsys.readouterr().err
    # The idle readers need no pairing.
    assert spans.idle_ns(t, ("wavefront.sort",)) is not None


def test_readers_on_a_traced_image():
    t = _paired_trace()
    read = {name: harness.load_reader(name) for name in READERS}
    got = {name: r(_ctx(t)) for name, r in read.items()}
    # Busy [130,160) [210,230) [330,370) [615,618) [815,822) of [0, 1000).
    assert got == {
        "prep_idle_ms_per_image": None,
        "bounce_idle_ms_per_image": (300 - 90) * 1e-6,
        "sort_idle_ms_per_image": (200 - 3) * 1e-6,
        "host_reads_per_image": 1.0,
        "worklist_ms_per_image": 30 * 1e-6,
        "bounce_torch_ms_per_image": 20 * 1e-6,
        "sort_ms_per_image": 10 * 1e-6,
    }


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_outside_their_kind(name):
    read = harness.load_reader(name)
    t = _paired_trace()
    assert read(_ctx(t, kind="preview")) is None
    assert read(_ctx(None)) is None
    # A program without spans (the parent of this change): nothing to read.
    bare = _trace(t.device, [h for h in t.host if h[0] not in spans.PROGRAM_SPANS])
    assert read(_ctx(bare)) is None


def test_readers_are_in_the_manifest():
    manifest = harness.load_manifest()
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "device_trace" and m["moves"] == "paths_per_s"
        assert "mesh_stress.offline" in m["workloads"]
        assert harness.reader_path(name).is_file()
    assert entries["prep_idle_ms_per_image"]["workloads"] == ["cornell.offline",
                                                             "mesh_stress.offline"]
