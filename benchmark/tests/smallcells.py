"""Small versions of the benchmark's cells for the CPU tests: the same
configurations and kinds, at a few pixels and samples.

The live-preview cells are not in `BENCHMARK.json` (their frame-time
tails spread too widely on the card for a bound), but their driver,
traffic, readers and `cornell.preview`'s limits stay, for a later cell;
`patch_manifest` adds the entries such a cell would bring.
"""

from __future__ import annotations

import copy

from benchmark import harness

PREVIEW_ENTRIES = {
    "workloads": [
        {"name": "cornell.preview", "config": "cornell", "traffic": "preview",
         "chips": 1, "why": "live preview of the Cornell box"},
        {"name": "mesh_stress.preview", "config": "mesh_stress", "traffic": "preview",
         "chips": 1, "why": "live preview of the mesh scene"}],
    "end_to_end": [
        {"name": "frame_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["cornell.preview", "mesh_stress.preview"]}],
    "per_layer": [
        {"name": "device_idle_share.preview", "unit": "share", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": "frame_ms_p95",
         "workloads": ["cornell.preview", "mesh_stress.preview"]},
        {"name": "launches_per_frame", "unit": "launches", "better": "lower",
         "source": "device_trace", "layer": "apps.interactive per-frame host path",
         "moves": "frame_ms_p95",
         "workloads": ["cornell.preview", "mesh_stress.preview"]}],
}
# Cells with limits, run whole; and every configuration under each kind,
# for the reference's agreement with the program.
WORKLOADS = ("cornell.offline", "mesh_stress.offline", "cornell.preview")
AGREEMENT = WORKLOADS + ("mesh_stress.preview",)


def with_preview(manifest: dict) -> dict:
    m = copy.deepcopy(manifest)
    for key, entries in PREVIEW_ENTRIES.items():
        m[key] += copy.deepcopy(entries)
    return m


def small_traffic(traffic: dict) -> dict:
    t = dict(traffic)
    t.update(width=16, height=12, judge_pixels=64, trace_jobs=2)
    if t["kind"] == "offline":
        t.update(spp=4, spp_per_pass=min(t.get("spp_per_pass", 0), 2), judge_jobs=2)
    else:
        t.update(burst_frames=4, rest_frames=3)
    return t


def patch_manifest(monkeypatch) -> None:
    """The manifest with the preview cells' entries, for this test."""
    orig = harness.load_manifest
    monkeypatch.setattr(harness, "load_manifest",
                        lambda root=harness.ROOT: with_preview(orig(root)))


def patch_small(monkeypatch) -> None:
    """Make every cell's traffic small, and the preview cells known, for
    this test."""
    orig = harness.load_traffic

    def load(name, bench_dir=harness.BENCH_DIR):
        return small_traffic(orig(name, bench_dir))

    monkeypatch.setattr(harness, "load_traffic", load)
    patch_manifest(monkeypatch)
