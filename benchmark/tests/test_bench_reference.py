"""The plain reference against the program's CPU route, its imports, and
the control and the planted faults that the comparison must catch.

Run from the repository's root: `python -m pytest benchmark/tests -q`.
"""

from __future__ import annotations

import ast
import pathlib
import time

import numpy as np
import pytest
import torch

from benchmark import control, drivers, harness, judge, program, run, scenedata
from benchmark.reference import pathtracer as pt
from benchmark.tests.smallcells import (
    AGREEMENT, WORKLOADS, patch_manifest, patch_small, small_traffic, with_preview,
)

REFERENCE_DIR = pathlib.Path(__file__).resolve().parents[1] / "reference"
CPU = torch.device("cpu")


def _cell(workload):
    c = harness.cell(with_preview(harness.load_manifest()), workload)
    return (scenedata.load_config(c["workload"]["config"]),
            small_traffic(harness.load_traffic(c["workload"]["traffic"])))


def _port_scene(cfg, tmp_path):
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    scene, camera = program.build_scene(cfg)
    return finalize(scene, bvh_cache_dir=str(tmp_path)), camera


@pytest.mark.parametrize("workload", [w for w in AGREEMENT if w.endswith("offline")])
def test_reference_matches_port_offline(workload, tmp_path):
    """Every judged value of a small image job agrees with the program's
    CPU route to rounding."""
    cfg, traffic = _cell(workload)
    scene, camera = _port_scene(cfg, tmp_path)
    d = drivers.Offline(scene, camera, traffic, 2**31 + 7, CPU)
    d.job()
    d.keep()
    rec = d.records()[0]
    ref, work = judge.reference_offline(cfg, traffic, rec["seed"], d.pixels, CPU)
    prog = pt.film_mean(rec["accum"], rec["samples"])
    assert rec["samples"] == traffic["spp"]
    assert not judge.off_mask("offline", prog, ref).any()
    assert torch.allclose(prog, ref, rtol=1e-5, atol=1e-6)
    assert work >= len(d.pixels) * traffic["spp"]


@pytest.mark.parametrize("workload", [w for w in AGREEMENT if w.endswith("preview")])
def test_reference_matches_port_preview(workload, tmp_path):
    """The displayed image after each frame of a script with bursts and
    rests agrees with the reference's replay of the camera commands."""
    cfg, traffic = _cell(workload)
    traffic["judge_jobs"] = 100  # keep every frame
    scene, camera = _port_scene(cfg, tmp_path)
    d = drivers.Preview(scene, camera, traffic, 12345, CPU)
    d.session = d._session(d.session_seed)
    frames = traffic["burst_frames"] + traffic["rest_frames"] + 3
    for _ in range(frames):
        d.job()
        d.keep()
    kept = {r["frame"]: r["u8"] for r in d.records()}
    assert sorted(kept) == list(range(frames))
    for frame in (0, 3, traffic["burst_frames"] + 1, frames - 1):
        ref, _ = judge.reference_preview(cfg, traffic, d.session_seed, d.script_seed,
                                         frame, d.pixels, CPU)
        off = judge.off_mask("preview", kept[frame], ref)
        assert int(off.sum()) == 0, (frame, int(off.sum()))


def test_judged_jobs_are_a_bounded_uniform_sample():
    """The last job and a seeded uniform sample of the others, whatever
    the window's length."""
    counts = np.zeros(50)
    for seed in range(2000):
        j = drivers.Judged(3, np.random.default_rng(seed))
        for i in range(51):
            j.add(i, i)
        got = [i for i, _ in j.jobs()]
        assert len(got) == 3 and got[-1] == 50 and len(set(got)) == 3
        counts[got[:-1]] += 1
    assert counts.min() > 0.5 * counts.mean()
    one = drivers.Judged(3, np.random.default_rng(0))
    one.add(0, "a")
    assert one.jobs() == [(0, "a")]


@pytest.mark.parametrize("seed", [99, 2**31 + 5, 4000000003])
def test_preview_script_returns_to_its_start(seed):
    """A burst's first half presses the live viewer's keys with their fixed
    steps; its second half undoes them: the pose after a burst is the pose
    before it, to float32 rounding."""
    traffic = harness.load_traffic("preview")
    cfg = scenedata.load_config("cornell")
    from benchmark.reference.session import CameraScript

    cam = CameraScript(pt.camera_from(cfg["scene"]["camera"]))
    start = {k: v.clone() for k, v in cam.params.items()}
    cmds = [c for f in range(traffic["burst_frames"])
            for c in drivers.preview_script(seed, traffic, f)]
    assert len(cmds) == traffic["burst_frames"] // traffic["frames_per_command"]
    steps = {tuple(v) for v in traffic["keys"].values()}
    assert {"w", "a", "s", "d", "q", "e", "j", "l", "i", "k", "o"} == set(traffic["keys"])
    assert all(c in steps for c in cmds[:len(cmds) // 2])
    assert cmds[len(cmds) // 2:] == [(n, -d) for n, d in reversed(cmds[:len(cmds) // 2])]
    for name, delta in cmds:
        cam.apply(name, delta)
    # yaw and pitch put the look-at point one unit ahead: the pose is the
    # eye and the view direction
    assert torch.allclose(cam.params["eye"], start["eye"], atol=1e-5)
    assert torch.allclose(cam._forward(), pt._norm(start["center"] - start["eye"]),
                          atol=1e-5)


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def test_reference_imports_nothing_of_the_program():
    """No module of the reference imports jax, the JAX package or the
    program (top-level names compared whole)."""
    files = sorted(REFERENCE_DIR.glob("*.py"))
    assert files
    banned = {"jax", "jaxlib", "flax", "raytracingthenextweekcuda_tpu",
              "raytracingthenextweekcuda_tpu_torch"}
    for path in files:
        assert not (_imports(path) & banned), path.name
    # Nor does the reader of the configurations' data, which both sides use.
    assert not (_imports(REFERENCE_DIR.parent / "scenedata.py") & banned)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(workload, monkeypatch):
    """The reference in bfloat16 put in the program's place reads far above
    the cell's limit."""
    patch_manifest(monkeypatch)
    c = harness.cell(harness.load_manifest(), workload)
    traffic = small_traffic(harness.load_traffic(c["workload"]["traffic"]))
    share = control.control_share(workload, 2**31 + 11, CPU, frames=(2, 6, 8),
                                  traffic=traffic)
    assert share > 3 * judge.load_limits(workload)["mismatch_share"], share


def test_control_draws_what_a_run_judges(tmp_path):
    """The control's pixels and job seeds are those a run of the same seed
    judges."""
    cfg, traffic = _cell("cornell.offline")
    scene, camera = _port_scene(cfg, tmp_path)
    d = drivers.Offline(scene, camera, traffic, 77, CPU)
    s = control.Setup(traffic, 77)
    d.warmup()
    for _ in range(traffic["judge_jobs"]):
        d.job()
        d.keep()
    assert np.array_equal(s.pixels, d.pixels)
    assert s.seeds == d.seeds
    ptr = small_traffic(harness.load_traffic("preview"))
    p = drivers.Preview(scene, camera, ptr, 77, CPU)
    s = control.Setup(ptr, 77)
    assert (s.session_seed, s.script_seed) == (p.session_seed, p.script_seed)
    assert np.array_equal(s.pixels, p.pixels)


# -- planted faults: a run with the timed path broken comes out not correct --

def _run(workload, monkeypatch, tmp_path):
    patch_small(monkeypatch)
    monkeypatch.setattr(run, "CACHE", tmp_path)
    args = run.parse(["--workload", workload, "--seed", str(2**31 + 3),
                      "--seconds", "0.3", "--trace", "0"])
    line, checks = run.run_cell(args, CPU, time.time())
    return line


def _fault_state_unchanged(monkeypatch, kind):
    """A pass that returns the film unchanged."""
    from raytracingthenextweekcuda_tpu_torch.models import film

    monkeypatch.setattr(film.Film, "add", lambda self, radiance, samples: self)


def _fault_half_batch(monkeypatch, kind):
    """Half of a pass's samples left out, the mean taken over the rest
    (offline); every other frame's pass left out, the mean over the rest
    (preview, one sample a frame)."""
    from raytracingthenextweekcuda_tpu_torch.models import film, integrator

    orig_pass, orig_add = integrator.render_pass, film.Film.add
    calls = []

    def half_pass(scene, camera, key, cfg, samples, device="cuda"):
        kept = max(1, samples // 2)
        return orig_pass(scene, camera, key, cfg, kept, device) * (samples / kept)

    def every_other(self, radiance, samples):
        calls.append(1)
        return self if len(calls) % 2 == 0 else orig_add(self, radiance, samples)

    if kind == "offline":
        monkeypatch.setattr(integrator, "render_pass", half_pass)
    else:
        monkeypatch.setattr(film.Film, "add", every_other)


def _fault_altered(monkeypatch, kind):
    """A pass's answer altered where it is produced: its pixels shifted by
    one along the row."""
    from raytracingthenextweekcuda_tpu_torch.models import integrator

    orig = integrator.render_pass

    def shifted(scene, camera, key, cfg, samples, device="cuda"):
        return torch.roll(orig(scene, camera, key, cfg, samples, device), 1, dims=1)

    monkeypatch.setattr(integrator, "render_pass", shifted)


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch, "altered": _fault_altered}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload, monkeypatch, tmp_path):
    line = _run(workload, monkeypatch, tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch, tmp_path):
    """Each fault a cell can have makes `correct` false. The cells run on
    one device, so there is no exchange between chips to leave out."""
    FAULTS[fault](monkeypatch, workload.rsplit(".", 1)[1])
    line = _run(workload, monkeypatch, tmp_path)
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.cuda
def test_reference_matches_k1_on_the_card(tmp_path):
    """On the card, the render kernel's image jobs agree with the
    reference run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    dev = torch.device("cuda")
    cfg, traffic = _cell("cornell.offline")
    traffic.update(width=64, height=48, spp=8, judge_pixels=512)
    scene, camera = _port_scene(cfg, tmp_path)
    d = drivers.Offline(scene, camera, traffic, 5, dev)
    d.job()
    d.keep()
    rec = d.records()[0]
    ref, _ = judge.reference_offline(cfg, traffic, rec["seed"], d.pixels, dev)
    prog = pt.film_mean(rec["accum"], rec["samples"])
    assert judge.off_mask("offline", prog, ref).float().mean() < 1e-2
