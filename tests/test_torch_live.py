"""The port's live frontend (apps/interactive.py, apps/viewer.py,
`rtnw-torch live`): the cases of tests/test_aux.py:80-175 for the port, and
a scripted session against the JAX reference's on the same commands.

Tolerances. The camera controls are a few float32 operations, whose sine
and cosine may round one ulp apart in the two libraries: camera fields at
1e-6. Frames are held at rtol = atol = 1e-4, but for at most 1 value in
10^4, the bar of the port's other renders against the reference.
"""

import io
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.apps.interactive import (
    InteractiveSession as JSession,
)
from raytracingthenextweekcuda_tpu.apps.viewer import run_live as jrun_live
from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.ops import linalg as jlinalg
from raytracingthenextweekcuda_tpu_torch import cli
from raytracingthenextweekcuda_tpu_torch.apps.interactive import InteractiveSession
from raytracingthenextweekcuda_tpu_torch.apps.viewer import (
    HTTPViewer,
    TerminalViewer,
    run_live,
)
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import linalg

CAMERA_FIELDS = ("eye", "center", "up", "fov", "aperture", "focus_distance",
                 "time0", "time1")


def _session(width, height, bounces, scene=None, **kw):
    if scene is None:
        scene = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=width, height=height, spp=1, bounces=bounces)
    return InteractiveSession(*scene, cfg, device="cpu", **kw)


def test_dirty_reset_and_screenshot(tmp_path):
    s = _session(16, 16, 3, spp_per_frame=1)
    s.step()
    s.step()
    assert s.sample_count == 2
    eye_before = s.camera.eye.clone()
    s.walk(0.5)
    assert not torch.allclose(s.camera.eye, eye_before)
    s.step()  # dirty: the film restarts
    assert s.sample_count == 1
    s.yaw(10.0)
    s.step()
    assert s.sample_count == 1
    s.set_fov(40.0)
    s.step()
    assert s.sample_count == 1
    s.set_moving_speed(3.0)  # the speed alone does not reset the film
    s.step()
    assert s.sample_count == 2
    path = s.screenshot(str(tmp_path))
    assert path.endswith("render_16x16_spp2.png") and os.path.exists(path)


def test_orbit_preserves_distance():
    s = _session(8, 8, 2)
    target = np.asarray((0.0, 0.0, -1.0))
    d0 = np.linalg.norm(s.camera.eye.numpy()[[0, 2]] - target[[0, 2]])
    for _ in range(10):
        s.orbit(tuple(target), 0.1)
    d1 = np.linalg.norm(s.camera.eye.numpy()[[0, 2]] - target[[0, 2]])
    np.testing.assert_allclose(d0, d1, rtol=1e-5)


def test_terminal_viewer_frame_and_live_loop(tmp_path):
    """Two idle frames, a walk (the film restarts), two frames, a
    screenshot at 2 spp, two more frames: 4 spp in the end."""
    scene, camera = presets.diffuse_sphere_plane()
    session = _session(32, 32, 3, scene=(finalize(scene), camera))
    out = io.StringIO()
    viewer = TerminalViewer(cols=16, rows=8, stream=out)
    shots = run_live(session, commands=["w", "enter", "x"], viewer=viewer,
                     frames_per_command=2, out_dir=str(tmp_path))
    text = out.getvalue()
    assert "\x1b[38;2;" in text and "▀" in text
    assert session.sample_count == 4
    assert len(shots) == 1 and shots[0].endswith("_spp2.png")
    img = (np.random.default_rng(0).random((40, 50, 3)) * 255).astype(np.uint8)
    assert viewer.frame_text(img, status="ok").count("\n") == 8


def _get(url: str) -> bytes:
    """GET without any proxy: the viewer serves on 127.0.0.1."""
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=5) as r:
        return r.read()


def test_http_viewer_serves_frames():
    v = HTTPViewer(port=0)
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        img[:, :, 1] = 200
        v.show(img)
        assert b"frame.png" in _get(f"http://127.0.0.1:{v.port}/")
        assert _get(f"http://127.0.0.1:{v.port}/frame.png").startswith(b"\x89PNG")
    finally:
        v.close()


def test_rotate_y_matches_reference():
    v = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    for deg in (-5.0, 10.0, 123.0):
        np.testing.assert_allclose(
            linalg.rotate_y(torch.from_numpy(v), deg).numpy(),
            np.asarray(jlinalg.rotate_y(jax.numpy.asarray(v), deg)),
            rtol=1e-6, atol=1e-6)


class _Recorder:
    """A viewer that keeps each frame's linear film mean."""

    def __init__(self, session, mean):
        self.session, self.mean, self.frames, self.spp = session, mean, [], []

    def show(self, img, spp=None):
        self.frames.append(self.mean(self.session))
        self.spp.append(spp)


SCRIPT = "w enter j ] x".split()


def test_scripted_session_matches_reference(tmp_path):
    cfg = dict(width=16, height=16, spp=1, bounces=3)
    jscene, jcam = jpresets.diffuse_sphere_plane()
    js = JSession(jscene, jcam, JConfig(**cfg))
    jrec = _Recorder(js, lambda s: np.asarray(s.film.mean))
    os.makedirs(tmp_path / "j")
    jshots = jrun_live(js, commands=SCRIPT, viewer=jrec, out_dir=str(tmp_path / "j"))

    scene, camera = presets.diffuse_sphere_plane()
    ts = InteractiveSession(scene, camera, RenderConfig(**cfg), device="cpu")
    trec = _Recorder(ts, lambda s: s.film.mean.numpy())
    tshots = run_live(ts, commands=SCRIPT, viewer=trec, out_dir=str(tmp_path))

    assert trec.spp == jrec.spp == [1, 2, 1, 2, 3, 4, 1, 2, 1, 2]
    assert [os.path.basename(p) for p in tshots] == ["render_16x16_spp2.png"]
    assert [os.path.basename(p) for p in jshots] == ["render_16x16_spp2.png"]
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(ts.camera, f).numpy(),
                                   np.asarray(getattr(js.camera, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    out, ref = np.stack(trec.frames), np.stack(jrec.frames)
    off = ~np.isclose(out, ref, rtol=1e-4, atol=1e-4)
    assert off.mean() <= 1e-4, f"{int(off.sum())} of {off.size} values apart"


def test_cli_live_script(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["live", "--preset", "sphere-plane", "--width", "16",
                     "--height", "16", "--bounces", "2", "--device", "cpu",
                     "--script", "w enter x"]) == 0
    captured = capsys.readouterr()
    assert "screenshot -> ./render_16x16_spp2.png" in captured.err
    assert (tmp_path / "render_16x16_spp2.png").exists()
    assert "spp 2" in captured.out


def test_live_session_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InteractiveSession(*presets.diffuse_sphere_plane())
