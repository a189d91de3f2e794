"""The port's timing, progress and checkpoint modules, and the render CLI's
per-pass flags, as the reference's tests/test_aux.py holds its own; a film
the reference saved loads in the port."""

import dataclasses

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import checkpoint as jcheckpoint
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu_torch import cli
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.io.image import read_png
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.checkpoint import (
    load_fit_state,
    load_render_state,
    render_resumable,
    save_fit_state,
    save_render_state,
)
from raytracingthenextweekcuda_tpu_torch.models.film import Film
from raytracingthenextweekcuda_tpu_torch.utils.progress import Progress
from raytracingthenextweekcuda_tpu_torch.utils.timing import Timer, sync, throughput

CFG = RenderConfig(width=16, height=16, spp=4, bounces=3, spp_per_pass=2)


def test_timer_and_throughput():
    t = Timer().start()
    x = torch.ones((128,)) * 2
    ms = t.stop(x)
    assert ms >= 0 and t.elapsed_ms == ms
    sync((x, [Film.create(2, 2)]))  # CPU tensors are ready: a no-op
    assert throughput(1000, 100.0) == 10000.0
    assert throughput(1000, 0.0) == float("inf")


def test_progress_prints_steps(capsys):
    """One line on stderr at every 10% step: each of 20 passes moves 5%."""
    p = Progress(20)
    for _ in range(20):
        p.update()
    err = capsys.readouterr().err
    assert "10.00%" in err and "100.00%" in err and "5.00%" not in err
    assert err.count("%") == 10


def test_checkpoint_roundtrip(tmp_path):
    scene, camera = presets.diffuse_sphere_plane()
    film = integrator.render(scene, camera, CFG, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    save_render_state(path, film, CFG.seed, 2, scene, camera, CFG)
    film2, seed, passes = load_render_state(path, scene, camera)
    assert torch.equal(film.accum, film2.accum)
    assert film2.sample_count == film.sample_count == CFG.spp
    assert seed == CFG.seed and passes == 2


def test_checkpoint_stale_detection(tmp_path):
    scene, camera = presets.diffuse_sphere_plane()
    path = str(tmp_path / "ckpt.npz")
    save_render_state(path, Film.create(CFG.width, CFG.height), CFG.seed, 1, scene,
                      camera, CFG)
    moved = dataclasses.replace(camera, eye=camera.eye + 1.0)
    with pytest.raises(ValueError, match="stale"):
        load_render_state(path, scene, moved)
    other, _ = presets.cornell_box()
    with pytest.raises(ValueError, match="stale"):
        load_render_state(path, other, camera)
    load_render_state(path)  # no scene given: nothing to check it by


def test_render_resumable_matches_straight_render(tmp_path):
    """Stopped after its first pass and resumed, the render equals a
    straight one bit for bit; resumed when complete, it changes nothing."""
    scene, camera = presets.diffuse_sphere_plane()
    straight = integrator.render(scene, camera, CFG, device="cpu")
    path = str(tmp_path / "resume")  # no .npz: the file is this path
    first = dataclasses.replace(CFG, spp=CFG.spp_per_pass)
    done = []
    half = render_resumable(scene, camera, first, path, device="cpu",
                            after_pass=lambda i, film: done.append(i))
    assert done == [0] and half.sample_count == 2
    _, _, passes = load_render_state(path, scene, camera)
    assert passes == 1
    film = render_resumable(scene, camera, CFG, path, device="cpu",
                            after_pass=lambda i, film: done.append(i))
    assert done == [0, 1]
    assert torch.equal(film.accum, straight.accum) and film.sample_count == CFG.spp
    again = render_resumable(scene, camera, CFG, path, device="cpu")
    assert torch.equal(again.accum, film.accum) and done == [0, 1]
    plain = render_resumable(scene, camera, CFG, device="cpu")  # no checkpoint
    assert torch.equal(plain.accum, straight.accum)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["resume"]


def test_reference_checkpoint_loads_in_port(tmp_path):
    """A film saved by the reference's save_render_state loads in the port,
    and the port's fingerprint of the same unfinalized scene and camera is
    the reference's, so resuming from it checks it and goes on."""
    jscene, jcamera = jpresets.diffuse_sphere_plane()
    jcfg = JConfig(width=16, height=16, spp=4, bounces=3, spp_per_pass=2)
    jfilm = jintegrator.render(jscene, jcamera, jcfg)
    path = str(tmp_path / "ref.npz")
    jcheckpoint.save_render_state(path, jfilm, jcfg.seed, 1, jscene, jcamera, jcfg)
    scene, camera = presets.diffuse_sphere_plane()
    film, seed, passes = load_render_state(path, scene, camera)
    assert np.array_equal(film.accum.numpy(), np.asarray(jfilm.accum))
    assert film.sample_count == int(jfilm.sample_count) and (seed, passes) == (1984, 1)
    resumed = render_resumable(scene, camera, CFG, path, device="cpu")
    assert resumed.sample_count == int(jfilm.sample_count) + 2


def test_fit_state_roundtrip(tmp_path):
    """Parameters and a torch.optim.Adam state after two steps: loaded into
    a fresh optimizer, the third step equals the original run's."""
    def run(params, opt, steps):
        for _ in range(steps):
            opt.zero_grad()
            sum(((p - 1.0) ** 2).sum() for p in params).backward()
            opt.step()

    params = [torch.zeros(3, requires_grad=True), torch.ones(2, 2, requires_grad=True)]
    opt = torch.optim.Adam(params, lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    run(params, opt, 2)
    path = str(tmp_path / "fit.npz")
    save_fit_state(path, params, opt.state_dict(), 2)
    loaded, state, step = load_fit_state(path)
    assert step == 2 and all(torch.equal(a, b.detach()) for a, b in zip(loaded, params))
    loaded = [p.requires_grad_() for p in loaded]
    opt2 = torch.optim.Adam(loaded, lr=0.5)
    opt2.load_state_dict(state)
    assert opt2.param_groups[0]["lr"] == 0.1
    run(params, opt, 1)
    run(loaded, opt2, 1)
    assert all(torch.equal(a, b) for a, b in zip(loaded, params))


def _render_args(out, *extra):
    return ["render", "--preset", "sphere-plane", "--width", "8", "--height", "6",
            "--spp", "4", "--spp-per-pass", "2", "--bounces", "2", "--device", "cpu",
            "--out", str(out), *extra]


def test_cli_progressive_writes_each_pass(tmp_path, monkeypatch):
    """`--progressive` rewrites the PNG after each pass: the first write
    holds pass 0's image, and the last one the whole render's."""
    from raytracingthenextweekcuda_tpu_torch.io import image

    writes = []
    write_png = image.write_png
    monkeypatch.setattr(image, "write_png",
                        lambda path, img: writes.append(img.copy()) or write_png(path, img))
    out = tmp_path / "p.png"
    assert cli.main(_render_args(out, "--progressive")) == 0
    assert len(writes) == 3  # two passes, then the final write
    assert not np.array_equal(writes[0], writes[1])
    assert np.array_equal(writes[1], writes[2]) and np.array_equal(read_png(str(out)),
                                                                   writes[2])


def test_cli_checkpoint_resumes(tmp_path):
    """`--checkpoint` writes the film after each pass; a second run resumes
    from it (nothing left to render) and writes the same image, which
    equals a run without a checkpoint."""
    ck = tmp_path / "r.npz"
    a, b, c = (tmp_path / f"{x}.png" for x in "abc")
    assert cli.main(_render_args(a, "--checkpoint", str(ck))) == 0
    _, _, passes = load_render_state(str(ck))
    assert passes == 2
    assert cli.main(_render_args(b, "--checkpoint", str(ck))) == 0
    assert cli.main(_render_args(c)) == 0
    assert np.array_equal(read_png(str(a)), read_png(str(b)))
    assert np.array_equal(read_png(str(a)), read_png(str(c)))


def test_cli_debug_nan_raises_on_a_nan(tmp_path, monkeypatch):
    """`--debug-nan` checks the film after each pass: a clean render passes,
    and a pass whose radiance holds a NaN put in by hand raises."""
    assert cli.main(_render_args(tmp_path / "ok.png", "--debug-nan")) == 0
    render_pass = integrator.render_pass

    def poisoned(*args, **kw):
        out = render_pass(*args, **kw).clone()
        out[1, 2, 0] = float("nan")
        return out

    monkeypatch.setattr(integrator, "render_pass", poisoned)
    with pytest.raises(FloatingPointError, match="pass 0"):
        cli.main(_render_args(tmp_path / "nan.png", "--debug-nan"))
    assert cli.main(_render_args(tmp_path / "unchecked.png")) == 0
