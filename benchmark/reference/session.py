"""The live-preview camera controls, replayed by the reference.

The upstream frontend's controls (Camera.h:40-84): walk, strafe and raise
move the eye and the look-at point by speed x delta along the view, right
and up axes; yaw turns the view about +y, pitch about the right axis;
orbit turns the eye about a target in the xz plane. All arithmetic is
float32 on the CPU, square roots in float64 rounded to float32, as the
program states it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.pathtracer import _cross, _f32, _norm

MOVING_SPEED = 1.5  # Camera.h:28


class CameraScript:
    """A camera's parameters (`pathtracer.camera_from`) under commands."""

    def __init__(self, params: dict):
        self.params = dict(params)

    def _forward(self):
        return _norm(self.params["center"] - self.params["eye"])

    def _right(self):
        return _norm(_cross(self._forward(), self.params["up"]))

    def _move(self, direction, delta: float) -> None:
        step = direction * (MOVING_SPEED * delta)
        self.params["eye"] = self.params["eye"] + step
        self.params["center"] = self.params["center"] + step

    def apply(self, name: str, delta: float) -> None:
        p = self.params
        if name == "walk":
            self._move(self._forward(), delta)
        elif name == "strafe":
            self._move(self._right(), delta)
        elif name == "raise_":
            self._move(p["up"], delta)
        elif name == "yaw":
            f = self._forward()[None, :]
            rad = torch.deg2rad(torch.as_tensor(delta, dtype=f.dtype))
            c, s = torch.cos(rad), torch.sin(rad)
            x, y, z = f[..., 0], f[..., 1], f[..., 2]
            nf = torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)[0]
            p["center"] = p["eye"] + nf
        elif name == "pitch":
            f, r = self._forward(), self._right()
            rad = torch.deg2rad(_f32(delta))
            p["center"] = p["eye"] + (f * torch.cos(rad) + _cross(r, f) * torch.sin(rad))
        elif name == "orbit":
            e = p["eye"]
            x, z = e[0], e[2]
            c, s = _f32(np.cos(delta)), _f32(np.sin(delta))
            zero = torch.tensor(np.float32(0.0))
            p["eye"] = torch.stack([x * c - z * s + zero, e[1], x * s + z * c + zero])
        else:
            raise ValueError(f"unknown camera command {name!r}")
