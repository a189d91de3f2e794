"""Interactive progressive-render session (counterpart of
raytracingthenextweekcuda_tpu/apps/interactive.py).

The capability of the realtime OpenGL/ImGui frontend
(OpenGLFrontend.cpp:422-620) without a window: a session owning a camera,
a scene and a progressive film, with the reference's controls -

  walk/strafe/raise_ (WASDQE movement, Camera.h:40-57, speed x delta),
  yaw/pitch (mouse look, Camera.h:58-77), orbit (Camera.h:78-84),
  set_aperture/set_fov/set_moving_speed (the ImGui sliders,
  OpenGLFrontend.cpp:189-197)

- each but the speed marking the camera dirty; the next `step()` then
clears the film, as pathTracing()'s dirty check does (main.cu:877-881).
`screenshot()` writes render_{W}x{H}_spp{N}.png (OpenGLFrontend.cpp:
334-342). The camera is the port's frozen `Camera`, changed with
`dataclasses.replace`; frame i renders with the key words
`fold_in(key(seed), i)` (ops/threefry.py), as the reference's session.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
from raytracingthenextweekcuda_tpu_torch.models.film import Film, to_image
from raytracingthenextweekcuda_tpu_torch.ops import linalg, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda.bounce_kernel import device_or_raise


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


class InteractiveSession:
    def __init__(self, scene, camera: Camera, cfg: RenderConfig | None = None,
                 spp_per_frame: int = 1, device="cuda"):
        if cfg is None:
            cfg = RenderConfig(width=512, height=512, spp=1, bounces=5)
        self.device = device_or_raise(device)
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.spp_per_frame = spp_per_frame
        self.moving_speed = 1.5  # Camera.h:28
        self.film = Film.create(cfg.width, cfg.height, device=self.device)
        self._dirty = True
        self._frame = 0
        self._key = threefry.key(cfg.seed)

    # -- camera controls (all but the speed mark the camera dirty) ----------
    def _replace(self, **fields) -> None:
        self.camera = dataclasses.replace(self.camera, **fields)
        self._dirty = True

    def _forward(self) -> torch.Tensor:
        return linalg.normalize(self.camera.center - self.camera.eye)

    def _right(self) -> torch.Tensor:
        return linalg.normalize(linalg.cross(self._forward(), self.camera.up))

    def _move(self, direction, delta: float) -> None:
        step = direction * (self.moving_speed * delta)
        self._replace(eye=self.camera.eye + step, center=self.camera.center + step)

    def walk(self, delta: float) -> None:
        self._move(self._forward(), delta)

    def strafe(self, delta: float) -> None:
        self._move(self._right(), delta)

    def raise_(self, delta: float) -> None:
        self._move(self.camera.up, delta)

    def yaw(self, degrees: float) -> None:
        forward = linalg.rotate_y(self._forward()[None, :], degrees)[0]
        self._replace(center=self.camera.eye + forward)

    def pitch(self, degrees: float) -> None:
        # Rotate forward about the right axis (Camera.h:69-76): Rodrigues
        # about the unit r, with f perpendicular to r.
        f, r = self._forward(), self._right()
        rad = torch.deg2rad(_f32(degrees))
        new_f = f * torch.cos(rad) + linalg.cross(r, f) * torch.sin(rad)
        self._replace(center=self.camera.eye + new_f)

    def orbit(self, target=(0.0, 0.0, 0.0), radians: float = 0.01) -> None:
        # XZ-plane orbit around target (Camera.h:78-84).
        t = torch.from_numpy(np.asarray(target, np.float32))
        e = self.camera.eye
        x, z = e[0] - t[0], e[2] - t[2]
        c, s = _f32(np.cos(radians)), _f32(np.sin(radians))
        self._replace(eye=torch.stack([x * c - z * s + t[0], e[1],
                                       x * s + z * c + t[2]]))

    def set_aperture(self, aperture: float) -> None:
        self._replace(aperture=_f32(aperture))

    def set_fov(self, fov: float) -> None:
        self._replace(fov=_f32(fov))

    def set_moving_speed(self, speed: float) -> None:
        self.moving_speed = float(speed)

    # -- frame loop ------------------------------------------------------------
    def step(self) -> Film:
        """Render one progressive frame (spp_per_frame samples).

        Mirrors pathTracing() (main.cu:875-888): a dirty camera clears the
        film; then the frame accumulates.
        """
        if self._dirty:
            self.film = Film.create(self.cfg.width, self.cfg.height,
                                    device=self.device)
            self._dirty = False
        pass_key = threefry.fold_in(self._key, self._frame)
        self.film = self.film.add(
            integrator.render_pass(self.scene, self.camera, pass_key, self.cfg,
                                   self.spp_per_frame, device=self.device),
            self.spp_per_frame)
        self._frame += 1
        return self.film

    @property
    def sample_count(self) -> int:
        return int(self.film.sample_count)

    def image(self) -> np.ndarray:
        return to_image(self.film)

    def screenshot(self, directory: str = ".") -> str:
        """render_{W}x{H}_spp{N}.png (OpenGLFrontend.cpp:334-342)."""
        from raytracingthenextweekcuda_tpu_torch.io.image import write_png

        name = f"render_{self.cfg.width}x{self.cfg.height}_spp{self.sample_count}.png"
        path = os.path.join(directory, name)
        write_png(path, self.image())
        return path


__all__ = ["InteractiveSession"]
