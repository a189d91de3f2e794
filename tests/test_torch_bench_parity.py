"""The port's benchmark line (apps/bench.py) and small helpers against the
JAX reference on the CPU.

`fp32_utilization` is the reference's `_vpu_utilization` (its static op
model of a render) over a peak that the caller passes: given the
reference's 3.9e12 it must give the reference's number on each preset and
on the 960-triangle mesh stand-in, equal after the reference's 4-digit
rounding and within 1e-12 relative before it, from packs whose counts
are equal. The headline's line (`run_bench`) is checked on the CPU at
8x8 with the CUDA check, the card's peak and the three mesh metrics
stubbed; the line on the card is `tests/test_torch_cuda.py`'s.
"""

import io
import json
import logging
import re
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.apps import bench as jbench
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops import linalg as jlinalg
from raytracingthenextweekcuda_tpu.utils import log as jlog
from raytracingthenextweekcuda_tpu.utils import progress as jprogress
from raytracingthenextweekcuda_tpu.utils import timing as jtiming
from raytracingthenextweekcuda_tpu_torch import cli
from raytracingthenextweekcuda_tpu_torch.apps import bench
from raytracingthenextweekcuda_tpu_torch.models import presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import linalg
from raytracingthenextweekcuda_tpu_torch.utils import log, progress, timing

V5E_PEAK = 3.9e12  # the reference's divisor (apps/bench.py:141)
HEADLINE = dict(paths=512 * 512 * 128, bounces=10)
# (preset, its arguments): the six presets and the 960-triangle stand-in
# of the published mesh scene (apps/bench_scenes.py).
SCENES = [("cornell_box", ()), ("defocus_blur", ()), ("rtiow_final", ()),
          ("diffuse_sphere_plane", ()), ("mesh_showcase", ()),
          ("smallpt_spheres", ()), ("mesh_showcase", (16, 32))]


def _unrounded_reference(monkeypatch, scene, paths, bounces, dt):
    """The reference's `_vpu_utilization` before its 4-digit rounding."""
    with monkeypatch.context() as m:
        m.setattr(jbench, "round", lambda x, ndigits=None: x, raising=False)
        return jbench._vpu_utilization(scene, paths, bounces, dt)


@pytest.mark.parametrize("preset,args", SCENES,
                         ids=[f"{p}{a}" if a else p for p, a in SCENES])
@pytest.mark.parametrize("dt", [0.0274, 0.1777])
def test_fp32_utilization_matches_reference(preset, args, dt, monkeypatch):
    jscene = jfinalize(getattr(jpresets, preset)(*args)[0])
    scene = finalize(getattr(presets, preset)(*args)[0])
    assert tuple(scene.packed.counts) == tuple(jscene.packed.counts)
    assert tuple(scene.packed.hcounts) == tuple(jscene.packed.hcounts)
    ref = jbench._vpu_utilization(jscene, HEADLINE["paths"], HEADLINE["bounces"], dt)
    ours = bench.fp32_utilization(scene, HEADLINE["paths"], HEADLINE["bounces"], dt,
                                  V5E_PEAK)
    assert round(ours, 4) == ref
    exact = _unrounded_reference(monkeypatch, jscene, HEADLINE["paths"],
                                 HEADLINE["bounces"], dt)
    assert abs(ours - exact) <= 1e-12 * abs(exact)


def test_fp32_utilization_of_an_unpacked_scene_is_none():
    assert jbench._vpu_utilization(jpresets.cornell_box()[0], 1, 1, 1.0) is None
    assert bench.fp32_utilization(presets.cornell_box()[0], 1, 1, 1.0, V5E_PEAK) is None


def test_fp32_utilization_of_the_headline():
    """560 modeled operations a path-bounce on Cornell (2 spheres, 6
    planes, 2 boxes), 1.8925e11 operations a headline render."""
    scene = finalize(presets.cornell_box()[0])
    ops = HEADLINE["paths"] * (40 + 10 * 560)
    assert bench.fp32_utilization(scene, HEADLINE["paths"], 10, 1.0, 1.0) == ops


@pytest.fixture
def fake_card(monkeypatch):
    """A Hopper card of 132 SMs whose nvidia-smi answers with `reply`."""
    reply = {"stdout": "GPU-1111, 1755\nGPU-abcd-ef, 1980\n", "rc": 0}
    props = types.SimpleNamespace(name="H100", major=9, minor=0,
                                  multi_processor_count=132, uuid="abcd-ef")
    monkeypatch.setattr(bench, "_cuda_device", torch.device)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)

    def run(cmd, **kw):
        assert cmd == ["nvidia-smi", "--query-gpu=uuid,clocks.max.sm",
                       "--format=csv,noheader,nounits"]
        return subprocess.CompletedProcess(cmd, reply["rc"], reply["stdout"], "")

    monkeypatch.setattr(bench.subprocess, "run", run)
    return reply, props


def test_fp32_peak_ops_reads_the_card(fake_card):
    assert bench.fp32_peak_ops("cuda") == 132 * 128 * 1980e6  # 33.45e12


@pytest.mark.parametrize("fault", ["no clock", "not hopper"])
def test_fp32_peak_ops_raises_without_a_clock(fault, fake_card):
    reply, props = fake_card
    if fault == "no clock":
        reply.update(stdout="", rc=9)
    else:
        props.major = 8
    with pytest.raises(RuntimeError):
        bench.fp32_peak_ops("cuda")


@pytest.fixture
def cpu_line(monkeypatch):
    """run_bench on the CPU: its CUDA check let through, the card's peak
    the reference's, and the three mesh metrics stubbed (their own lines
    are `tests/test_torch_bench_mesh.py`'s)."""
    monkeypatch.setattr(bench, "_cuda_device", torch.device)
    monkeypatch.setattr(bench, "fp32_peak_ops", lambda device: V5E_PEAK)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "cpu")
    calls = []
    for name in ("run_mesh_bench", "run_mesh_stress", "run_mesh_large"):
        def stub(device, name=name):
            calls.append((name, device))
            return {"metric": name, "paths_per_sec": 1.0}
        monkeypatch.setattr(bench, name, stub)
    return calls


SMALL = dict(width=8, height=8, spp=1, bounces=1, spp_per_pass=1, device="cpu")


def test_headline_line_carries_fp32_util_and_the_mesh_metrics(cpu_line):
    line = bench.run_bench(**SMALL)
    scene = finalize(presets.cornell_box()[0])
    share = bench.fp32_utilization(scene, 64, 1, line["render_ms"] / 1e3, V5E_PEAK)
    assert line["fp32_util"] == pytest.approx(share, abs=1e-4)
    assert line["fp32_peak_ops"] == V5E_PEAK
    note = line["fp32_util_note"]
    assert "upper bound" in note and "every bounce of every path" in note
    assert "TPU" not in note and "v5e" not in note
    assert [line[k]["metric"] for k in ("mesh_bvh", "mesh_stress", "mesh_large")] == [
        "run_mesh_bench", "run_mesh_stress", "run_mesh_large"]
    assert all(device == torch.device("cpu") for _, device in cpu_line)
    assert "vs_baseline" not in line and "vpu_util" not in line
    json.dumps(line)  # one JSON line


def test_headline_line_without_the_mesh_metrics(cpu_line):
    line = bench.run_bench(**SMALL, mesh=False)
    assert not cpu_line and not {"mesh_bvh", "mesh_stress", "mesh_large"} & set(line)


def test_a_failing_mesh_metric_propagates(cpu_line, monkeypatch):
    def fails(device):
        raise RuntimeError("mesh_stress failed")

    monkeypatch.setattr(bench, "run_mesh_stress", fails)
    with pytest.raises(RuntimeError, match="mesh_stress failed"):
        bench.run_bench(**SMALL)


def test_cli_bench_prints_the_whole_line(monkeypatch, capsys):
    seen = {}

    def run_bench(**kw):
        seen.update(kw)
        return {"metric": "headline", "mesh_bvh": {}, "mesh_stress": {},
                "mesh_large": {}}

    monkeypatch.setattr(bench, "run_bench", run_bench)
    assert cli.main(["bench"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mesh_bvh", "mesh_stress", "mesh_large"} <= set(line)
    assert seen["mesh"] is True and seen["spp"] == 128 and seen["bounces"] == 10
    assert seen["device"] == "cuda"


def test_get_logger_matches_reference():
    ref, ours = jlog.get_logger("parity-ref"), log.get_logger("parity-port")
    assert log.get_logger("parity-port") is ours and len(ours.handlers) == 1
    assert ours.level == ref.level == logging.INFO
    record = logging.LogRecord("x", logging.WARNING, __file__, 1, "hit %d", (3,), None)
    assert (ours.handlers[0].formatter.format(record)
            == ref.handlers[0].formatter.format(record) == "[WARNING x] hit 3")


def test_timed_matches_reference():
    lines = {}
    for name, module, value in (("ref", jtiming, jnp.ones(4)),
                                ("port", timing, torch.ones(4))):
        printed = []
        with module.timed("render", printer=printed.append) as box:
            box["result"] = value * 2
        lines[name] = printed
    for printed in lines.values():
        assert len(printed) == 1 and re.fullmatch(r"render: \d+\.\d{3} ms", printed[0])


def test_length_matches_reference():
    v = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(linalg.length(torch.from_numpy(v)).numpy(),
                               np.asarray(jlinalg.length(jnp.asarray(v))), rtol=1e-6)


@pytest.mark.parametrize("rows", [5, 80, 600])  # each of the reference's branches
def test_take_rows_and_take_scalar_match_reference(rows):
    gen = np.random.default_rng(rows)
    table = gen.normal(size=(rows, 3)).astype(np.float32)
    idx = gen.integers(0, rows, 256).astype(np.int32)
    t, i = torch.from_numpy(table), torch.from_numpy(idx).long()
    np.testing.assert_array_equal(linalg.take_rows(t, i).numpy(),
                                  np.asarray(jlinalg.take_rows(jnp.asarray(table),
                                                               jnp.asarray(idx))))
    np.testing.assert_array_equal(
        linalg.take_scalar(t[:, 1], i).numpy(),
        np.asarray(jlinalg.take_scalar(jnp.asarray(table[:, 1]), jnp.asarray(idx))))


def test_progress_finish_matches_reference(capsys):
    def steps(text):
        return re.sub(r"\(\d+\.\ds\)", "(t)", text)

    stream = io.StringIO()
    ref = jprogress.Progress(3, stream=stream)
    ours = progress.Progress(3)
    for p in (ref, ours):
        p.update()
        p.finish()
        p.finish()  # done: prints nothing more
    assert steps(capsys.readouterr().err) == steps(stream.getvalue())
    assert steps(stream.getvalue()) == "Complete: 33.33%  (t)\nComplete: 100.00%  (t)\n"
