"""The `rtiow_final` configuration and its cell `rtiow_final.offline`: the
data against the port's preset, the plain reference against the port's
CPU route on every sphere, and the comparison that decides `correct`
(a sound run, the planted faults, the control) at a small size.

Run from the repository's root: `python -m pytest benchmark/tests -q`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import control, drivers, harness, judge, program, roofline, scenedata
from benchmark.reference import pathtracer as pt
from benchmark.tests.smallcells import patch_small, small_traffic
from benchmark.tests.test_bench_reference import FAULTS, _run
from benchmark.tests.test_bench_scenes import _camera_same, _same

WORKLOAD = "rtiow_final.offline"
CPU = torch.device("cpu")


def test_config_is_the_preset():
    """Sphere by sphere, material by material and the camera: the data is
    presets.rtiow_final(seed=0) in float32."""
    from raytracingthenextweekcuda_tpu_torch.models import presets

    cfg = scenedata.load_config("rtiow_final")
    scene, camera = program.build_scene(cfg)
    want, want_cam = presets.rtiow_final(seed=0)
    _same(scene, want)
    _camera_same(camera, want_cam)
    moving = (scene.spheres.center1 != scene.spheres.center0).any(axis=1)
    assert scene.spheres.count == cfg["spheres"] == 488
    assert int(moving.sum()) == cfg["moving_spheres"] == 385
    assert scene.materials.count == 488
    assert np.array_equal(np.sort(scene.spheres.material_id), np.arange(488))
    assert cfg["reduced"] == []
    assert roofline.primitive_counts(cfg) == {"spheres": 488, "planes": 0,
                                              "boxes": 0, "triangles": 0}


def test_cell_is_one_card_k1_job():
    """The cell's traffic is the published job, and the port routes the
    scene to K1 (no tile-BVH, no triangles)."""
    from raytracingthenextweekcuda_tpu_torch.models import integrator
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    c = harness.cell(harness.load_manifest(), WORKLOAD)
    assert c["workload"]["chips"] == 1 and c["config"]["name"] == "rtiow_final"
    t = harness.load_traffic(c["workload"]["traffic"])
    assert (t["width"], t["height"], t["spp"], t["bounces"], t["spp_per_pass"]) == \
        (1200, 800, 10, 50, 0)
    assert {m["name"] for m in c["per_layer"]} == {"device_idle_share.offline",
                                                  "k1_roofline"}
    scene = finalize(program.build_scene(scenedata.load_config("rtiow_final"))[0])
    assert scene.packed is not None and not integrator._sorted_eligible(scene)


@pytest.mark.parametrize("seed", [2**31 + 7, 4100000009])
def test_reference_matches_port(seed, tmp_path):
    """Every judged value of a 24x16, 2-spp, 50-bounce job over all 488
    spheres agrees with the program's CPU route under the judge's own
    tolerance."""
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    cfg = scenedata.load_config("rtiow_final")
    traffic = dict(harness.load_traffic("offline_rtiow"))
    traffic.update(width=24, height=16, spp=2, judge_pixels=24 * 16, judge_jobs=1)
    scene, camera = program.build_scene(cfg)
    scene = finalize(scene, bvh_cache_dir=str(tmp_path))
    d = drivers.Offline(scene, camera, traffic, seed, CPU)
    d.job()
    d.keep()
    rec = d.records()[0]
    ref, work = judge.reference_offline(cfg, traffic, rec["seed"], d.pixels, CPU)
    prog = pt.film_mean(rec["accum"], rec["samples"])
    assert rec["samples"] == 2 and prog.shape == (24 * 16, 3)
    assert not judge.off_mask("offline", prog, ref).any()
    assert work > 2 * len(d.pixels) * traffic["spp"]


def test_sound_run_is_correct(monkeypatch, tmp_path):
    line = _run(WORKLOAD, monkeypatch, tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"paths_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch, tmp_path):
    FAULTS[fault](monkeypatch, "offline")
    line = _run(WORKLOAD, monkeypatch, tmp_path)
    assert not line["correct"], (fault, line["checks"])


def test_control_fails(monkeypatch):
    """The reference in bfloat16 put in the program's place reads far above
    the cell's limit."""
    patch_small(monkeypatch)
    traffic = small_traffic(harness.load_traffic("offline_rtiow"))
    share = control.control_share(WORKLOAD, 2**31 + 11, CPU, traffic=traffic)
    assert share > 3 * judge.load_limits(WORKLOAD)["mismatch_share"], share
