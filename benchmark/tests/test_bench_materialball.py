"""The `materialball_x48` configuration and its cell
`materialball_x48.offline` at a small size on the CPU: the plain reference
against the port's CPU route, by the exact work lists and by the
packet-frustum pass that the full scene's 4,336 leaves take, and the
comparison that decides `correct` (a sound run, the planted faults, the
control).

The small version keeps the configuration's box, camera and materials and
its first four balls, scaled and offset as in the file, at 16 x 32 in
place of 113 x 209: the full scene's 2.25 M triangles are the card's.

Run from the repository's root: `python -m pytest benchmark/tests -q`.
"""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import control, drivers, harness, judge, program, scenedata
from benchmark.reference import pathtracer as pt
from benchmark.tests.smallcells import patch_small, small_traffic
from benchmark.tests.test_bench_reference import FAULTS, _run

WORKLOAD = "materialball_x48.offline"
CONFIG = "materialball_x48"
CPU = torch.device("cpu")


def _small_config() -> dict:
    cfg = copy.deepcopy(scenedata.load_config(CONFIG))
    prims = cfg["scene"]["primitives"]
    balls = [p for p in prims if p.get("generator") == "uv_sphere"]
    for b in balls[:4]:
        b["params"].update(n_lat=16, n_lon=32)
    cfg["scene"]["primitives"] = [p for p in prims if p not in balls] + balls[:4]
    return cfg


def _patch_config(monkeypatch) -> dict:
    """The small version in the place of the configuration's file."""
    small = _small_config()
    orig = scenedata.load_config
    monkeypatch.setattr(scenedata, "load_config",
                        lambda name: copy.deepcopy(small) if name == CONFIG
                        else orig(name))
    return small


def test_cell_is_the_published_job():
    c = harness.cell(harness.load_manifest(), WORKLOAD)
    t = harness.load_traffic(c["workload"]["traffic"])
    assert (t["kind"], t["width"], t["height"], t["spp"], t["spp_per_pass"],
            t["bounces"]) == ("offline", 512, 512, 16, 16, 5)
    assert t["width"] * t["height"] * t["spp"] == 4 * 1024 * 1024
    assert c["workload"]["chips"] == 1 and c["config"]["reduced"] == []
    assert [m["name"] for m in c["end_to_end"]] == ["paths_per_s", "setup_s"]
    # Two per-layer lists stay as they were: benchmark tests pin them.
    assert not {"prep_idle_ms_per_image", "shade_ms_per_image"} & {
        m["name"] for m in c["per_layer"]}


@pytest.mark.parametrize("frustum", [False, True], ids=["exact", "frustum"])
def test_reference_matches_port(frustum, monkeypatch, tmp_path):
    """Every judged value of a small image job agrees with the program's
    CPU route to rounding, by either work-list pass."""
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    if frustum:
        monkeypatch.setattr(k4, "FRUSTUM_LEAF_THRESHOLD", 0)
    cfg = _small_config()
    traffic = small_traffic(harness.load_traffic("offline_mesh_large"))
    scene, camera = program.build_scene(cfg)
    scene = finalize(scene, bvh_cache_dir=str(tmp_path))
    assert k4.use_frustum_worklist(scene.packed.leaf_bounds.shape[1]) == frustum
    d = drivers.Offline(scene, camera, traffic, 2**31 + 23, CPU)
    d.job()
    d.keep()
    rec = d.records()[0]
    ref, work = judge.reference_offline(cfg, traffic, rec["seed"], d.pixels, CPU)
    prog = pt.film_mean(rec["accum"], rec["samples"])
    assert rec["samples"] == traffic["spp"]
    assert not judge.off_mask("offline", prog, ref).any()
    assert torch.allclose(prog, ref, rtol=1e-5, atol=1e-6)
    assert work >= len(d.pixels) * traffic["spp"]


def test_sound_run_is_correct(monkeypatch, tmp_path):
    _patch_config(monkeypatch)
    line = _run(WORKLOAD, monkeypatch, tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch, tmp_path):
    _patch_config(monkeypatch)
    FAULTS[fault](monkeypatch, "offline")
    line = _run(WORKLOAD, monkeypatch, tmp_path)
    assert not line["correct"], (fault, line["checks"])


def test_control_fails(monkeypatch):
    """The reference in bfloat16 put in the program's place reads far above
    the cell's limit."""
    _patch_config(monkeypatch)
    patch_small(monkeypatch)
    share = control.control_share(WORKLOAD, 2**31 + 29, CPU)
    assert share > 3 * judge.load_limits(WORKLOAD)["mismatch_share"], share
