"""The shade kernel's reader, `shade_ms_per_image`, on synthetic traces:
the shade kernel's device time per image, also where the spans cannot be
paired with their enqueue calls; None outside its kind and on a program
without the kernel (the parent of the change that added it)."""

from __future__ import annotations

import types

from benchmark import harness, spans
from benchmark.profiling import Trace


def _trace(extra_host=(), extra_device=()):
    """Two images, a bounce each with one enqueue in K4's span and one in
    the shade span."""
    host = [
        ("integrator.render", 0, 500),
        ("wavefront.bounce", 100, 300),
        ("k4.winner", 110, 50),
        ("cudaLaunchKernel", 120, 5),
        ("wavefront.shade", 200, 40),
        ("cudaLaunchKernel", 210, 5),
        ("integrator.render", 500, 490),
        ("wavefront.bounce", 600, 300),
        ("cudaLaunchKernel", 610, 5),
        ("wavefront.shade", 700, 40),
        ("cudaLaunchKernel", 705, 5),
        *extra_host,
    ]
    device = [
        ("bvh_winner_kernel", 130, 50, "kernel"),
        ("(anonymous namespace)::shade_kernel(ShadeArgs)", 220, 11, "kernel"),
        ("where", 620, 7, "kernel"),
        ("(anonymous namespace)::shade_kernel(ShadeArgs)", 720, 13, "kernel"),
        *extra_device,
    ]
    return Trace(jobs=2, window_ns=(0, 1000), device=device, host=host)


def _read(trace, kind="offline"):
    return harness.load_reader("shade_ms_per_image")(
        types.SimpleNamespace(kind=kind, trace=trace))


def test_reads_the_shade_kernels_device_time_per_image():
    t = _trace()
    assert _read(t) == (11 + 13) / 2 * 1e-6
    # The same operations as those enqueued inside `wavefront.shade`.
    shade = [(s, s + d) for n, s, d in t.host if n == "wavefront.shade"]
    inside = sum(d for c, d, _ in spans.attribution(t)
                 if any(a <= c < b for a, b in shade))
    assert inside == 11 + 13


def test_reads_without_a_pairing():
    slack = spans.CLOCK_SLACK_NS
    t = _trace(extra_host=[("cudaLaunchKernel", 900 + 2 * slack, 5)],
               extra_device=[("early", 900 + slack - 1, 5, "kernel")])
    assert spans.attribution(t) is None
    assert _read(t) == (11 + 13) / 2 * 1e-6


def test_none_outside_its_kind_or_without_the_kernel():
    t = _trace()
    assert _read(t, kind="preview") is None
    assert _read(None) is None
    parent = Trace(jobs=2, window_ns=t.window_ns,
                   device=[e for e in t.device if "shade_kernel" not in e[0]],
                   host=[h for h in t.host if h[0] != "wavefront.shade"])
    assert _read(parent) is None


def test_reader_is_in_the_manifest():
    entry = {m["name"]: m for m in harness.load_manifest()["per_layer"]}[
        "shade_ms_per_image"]
    assert entry == {"name": "shade_ms_per_image", "unit": "ms", "better": "lower",
                     "source": "device_trace", "layer": "ops.cuda.shade_kernel",
                     "moves": "paths_per_s", "workloads": ["mesh_stress.offline"]}
    assert harness.reader_path("shade_ms_per_image").is_file()
