"""Live preview viewers for the progressive renderer (a copy of
raytracingthenextweekcuda_tpu/apps/viewer.py, numpy and the standard
library only; the port never imports the JAX package).

The reference displays its progressive accumulation through a GL textured
quad + ImGui overlay (OpenGLFrontend.cpp:483-557). On a headless host the
equivalent "display" is the terminal: `TerminalViewer` draws the current
film as 24-bit-color half-block characters (two pixels per character cell,
'▀' upper half colored by the top pixel, background by the bottom),
redrawn in place every frame, with the FPS / accumulated-spp readout the
reference shows in its window title + ImGui panel
(OpenGLFrontend.cpp:223-276). `HTTPViewer` serves the latest frame as an
auto-refreshing page for a browser on the same host.

Both consume plain (H, W, 3) uint8 frames (y=0 at the top), so they attach
to `InteractiveSession.image()` or any PNG-bound buffer.
"""

from __future__ import annotations

import sys
import time

import numpy as np

_HALF = "▀"  # upper half block
_HOME = "\x1b[H"
_CLEAR = "\x1b[2J"
_RESET = "\x1b[0m"


def _downsample(img: np.ndarray, cols: int, rows2: int) -> np.ndarray:
    """Box-average (H, W, 3) to exactly (rows2, cols, 3) uint8."""
    h, w = img.shape[:2]
    ys = (np.arange(rows2 + 1) * h) // rows2
    xs = (np.arange(cols + 1) * w) // cols
    out = np.empty((rows2, cols, 3), np.float32)
    # Cheap two-pass box filter via cumulative sums.
    ii = np.zeros((h + 1, w + 1, 3), np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(img.astype(np.float64), 0), 1)
    for j in range(rows2):
        y0, y1 = ys[j], max(ys[j + 1], ys[j] + 1)
        for_slice = ii[y1] - ii[y0]
        seg = for_slice[xs[1:]] - for_slice[xs[:-1]]
        area = (y1 - y0) * np.maximum(xs[1:] - xs[:-1], 1)[:, None]
        out[j] = seg / area
    return np.clip(out, 0, 255).astype(np.uint8)


class TerminalViewer:
    """ANSI truecolor half-block display, redrawn in place per frame."""

    def __init__(self, cols: int = 64, rows: int = 28, stream=None):
        self.cols = cols
        self.rows = rows
        self.stream = stream if stream is not None else sys.stdout
        self._first = True
        self._t_last = None

    def frame_text(self, img: np.ndarray, status: str = "") -> str:
        """Render one frame to an ANSI string (exposed for tests)."""
        small = _downsample(np.asarray(img, np.uint8), self.cols,
                            self.rows * 2)
        lines = []
        for r in range(self.rows):
            top = small[2 * r]
            bot = small[2 * r + 1]
            cells = []
            for c in range(self.cols):
                tr, tg, tb = (int(v) for v in top[c])
                br, bg, bb = (int(v) for v in bot[c])
                cells.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m"
                    f"{_HALF}"
                )
            lines.append("".join(cells) + _RESET)
        if status:
            lines.append(status[: self.cols * 2])
        return "\n".join(lines)

    def show(self, img: np.ndarray, spp: int | None = None) -> None:
        now = time.perf_counter()
        fps = (
            1.0 / (now - self._t_last)
            if self._t_last is not None and now > self._t_last else 0.0
        )
        self._t_last = now
        status = _RESET + (
            f" {fps:5.1f} fps | spp {spp} " if spp is not None
            else f" {fps:5.1f} fps "
        )
        prefix = _CLEAR + _HOME if self._first else _HOME
        self._first = False
        self.stream.write(prefix + self.frame_text(img, status) + "\n")
        self.stream.flush()


class HTTPViewer:
    """Serve the latest frame as a PNG behind an auto-refresh page."""

    def __init__(self, port: int = 8000):
        import http.server
        import threading

        self._latest: bytes = b""
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib name)
                if self.path.startswith("/frame.png"):
                    body = viewer._latest
                    ctype = "image/png"
                else:
                    body = (
                        b"<html><head><meta http-equiv='refresh' "
                        b"content='1'></head><body style='background:#111'>"
                        b"<img src='/frame.png' style='width:90vmin'>"
                        b"</body></html>"
                    )
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silent
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def show(self, img: np.ndarray, spp: int | None = None) -> None:
        from raytracingthenextweekcuda_tpu_torch.io.image import png_bytes

        self._latest = png_bytes(np.asarray(img, np.uint8))

    def close(self) -> None:
        self._server.shutdown()


def run_live(session, commands=None, viewer=None, frames_per_command: int = 2,
             out_dir: str = "."):
    """Drive an InteractiveSession visibly: render, draw, apply controls.

    `commands` is an iterable of control strings (scripted mode / piped
    stdin); None reads lines from stdin interactively. Commands mirror the
    reference's key bindings (OpenGLFrontend.cpp:576-612):

      w/s walk  a/d strafe  q/e raise/lower  j/l yaw  i/k pitch
      o orbit   [ / ] fov   enter screenshot  . idle (just accumulate)
      quit/x    stop

    Each command renders `frames_per_command` progressive frames so the
    dirty-reset (accumulation restarting at 1 spp after a move,
    main.cu:877-881) is visible in the spp readout.
    """
    if viewer is None:
        viewer = TerminalViewer()

    def frames():
        for _ in range(frames_per_command):
            session.step()
            viewer.show(session.image(), spp=session.sample_count)

    frames()
    if commands is None:
        commands = iter(sys.stdin.readline, "")
    shots = []
    for raw in commands:
        cmd = raw.strip().lower()
        if cmd in ("quit", "x"):
            break
        elif cmd == "w":
            session.walk(0.1)
        elif cmd == "s":
            session.walk(-0.1)
        elif cmd == "a":
            session.strafe(-0.1)
        elif cmd == "d":
            session.strafe(0.1)
        elif cmd == "q":
            session.raise_(0.1)
        elif cmd == "e":
            session.raise_(-0.1)
        elif cmd == "j":
            session.yaw(-5.0)
        elif cmd == "l":
            session.yaw(5.0)
        elif cmd == "i":
            session.pitch(5.0)
        elif cmd == "k":
            session.pitch(-5.0)
        elif cmd == "o":
            session.orbit(radians=0.15)
        elif cmd == "[":
            session.set_fov(float(session.camera.fov) - 5.0)
        elif cmd == "]":
            session.set_fov(float(session.camera.fov) + 5.0)
        elif cmd in ("enter", ""):
            shots.append(session.screenshot(out_dir))
        # "." and unknown commands: idle — accumulate only
        frames()
    return shots


__all__ = ["TerminalViewer", "HTTPViewer", "run_live"]
