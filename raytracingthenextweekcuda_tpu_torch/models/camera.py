"""Thin-lens camera and primary-ray generation (counterpart of
raytracingthenextweekcuda_tpu/models/camera.py).

`Camera` holds the user parameters, `derive` the viewport frame, and
`pack_frame` the 21 floats the render kernel reads. `raygen` is the
kernel's ray generation in plain torch: one jittered thin-lens ray per
pixel id from the pcg4d stream of one sample's key words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.ops import linalg
from raytracingthenextweekcuda_tpu_torch.ops.rng import (
    RAYGEN_DOMAIN,
    RAYGEN_DOMAIN2,
    pcg4d,
    to_uniform,
)

TWO_PI = 6.283185307179586


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


@dataclasses.dataclass(frozen=True)
class Camera:
    """User parameters; float32 CPU tensors."""

    eye: torch.Tensor             # (3,)
    center: torch.Tensor          # (3,) look-at point
    up: torch.Tensor              # (3,)
    fov: torch.Tensor             # () degrees, vertical
    aperture: torch.Tensor        # ()
    focus_distance: torch.Tensor  # ()
    time0: torch.Tensor           # () shutter open
    time1: torch.Tensor           # () shutter close

    @staticmethod
    def make(eye, center, up=(0.0, 1.0, 0.0), fov=90.0, aperture=2.0,
             focus_distance=1.0, time0=0.0, time1=0.0) -> "Camera":
        return Camera(eye=_t(eye), center=_t(center), up=_t(up), fov=_t(fov),
                      aperture=_t(aperture), focus_distance=_t(focus_distance),
                      time0=_t(time0), time1=_t(time1))

    @staticmethod
    def from_numpy(arrays: dict) -> "Camera":
        """A Camera from arrays keyed by field name (a reference Camera's
        leaves, for instance)."""
        return Camera(**{f.name: _t(arrays[f.name])
                         for f in dataclasses.fields(Camera)})


@dataclasses.dataclass(frozen=True)
class CameraFrame:
    """Derived viewport frame."""

    origin: torch.Tensor
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    right: torch.Tensor
    true_up: torch.Tensor
    lens_radius: torch.Tensor
    time0: torch.Tensor
    time1: torch.Tensor


def derive(camera: Camera, aspect_ratio: float) -> CameraFrame:
    """The viewport frame of a camera, in float32 (tan taken in float64 and
    rounded)."""
    half = camera.fov / 2.0
    scale = torch.tan((half * float(np.float32(np.pi / 180))).double()).float()
    viewport_h = 2.0 * scale
    viewport_w = viewport_h * aspect_ratio
    forward = linalg.normalize(camera.center - camera.eye)
    right = linalg.normalize(linalg.cross(forward, camera.up))
    true_up = linalg.cross(right, forward)
    horizontal = viewport_w * right * camera.focus_distance
    vertical = viewport_h * true_up * camera.focus_distance
    lower_left = (camera.eye - horizontal / 2.0 - vertical / 2.0
                  + forward * camera.focus_distance)
    return CameraFrame(
        origin=camera.eye, lower_left=lower_left, horizontal=horizontal,
        vertical=vertical, right=right, true_up=true_up,
        lens_radius=camera.aperture / 2.0,
        time0=camera.time0, time1=camera.time1,
    )


def pack_frame(frame: CameraFrame, device=None) -> torch.Tensor:
    """CameraFrame -> the kernel's 21 floats: origin, lower_left,
    horizontal, vertical, right, true_up, lens_radius, time0, time1."""
    parts = [frame.origin, frame.lower_left, frame.horizontal, frame.vertical,
             frame.right, frame.true_up, frame.lens_radius, frame.time0,
             frame.time1]
    return torch.cat([
        torch.as_tensor(p, dtype=torch.float32).reshape(-1).cpu() for p in parts
    ]).to(device)


def raygen(pid: torch.Tensor, b0: int, b1: int, frame: torch.Tensor,
           width: int, height: int):
    """Thin-lens primary rays for int64 pixel ids `pid` and one sample's key
    words (b0, b1); `frame` is `pack_frame`'s vector on pid's device.

    Pixel placement (x+u)/(width-1) is a true division; the lens disk is
    closed-form; directions are normalized with a float32 1/sqrt.
    Returns (ox, oy, oz, dx, dy, dz, time), each (N,) float32.
    """
    xs = (pid % width).to(torch.float32)
    ys = torch.div(pid, width, rounding_mode="floor").to(torch.float32)
    h0, h1, h2, h3 = pcg4d(pid, b0, RAYGEN_DOMAIN, b1)
    u0, u1, u2, u3 = (to_uniform(h) for h in (h0, h1, h2, h3))
    u4 = to_uniform(pcg4d(pid, b0, RAYGEN_DOMAIN2, b1)[0])
    f = [frame[i] for i in range(21)]
    dxs = (xs + u0) / torch.full_like(xs, width - 1.0)
    dys = (ys + u1) / torch.full_like(ys, height - 1.0)
    r = torch.sqrt(u2.double()).float()
    phi = (TWO_PI * u3).double()
    disk_x = f[18] * r * torch.cos(phi).float()
    disk_y = f[18] * r * torch.sin(phi).float()
    ox = f[0] + disk_x * f[12] + disk_y * f[15]
    oy = f[1] + disk_x * f[13] + disk_y * f[16]
    oz = f[2] + disk_x * f[14] + disk_y * f[17]
    dx = f[3] + dxs * f[6] + dys * f[9] - ox
    dy = f[4] + dxs * f[7] + dys * f[10] - oy
    dz = f[5] + dxs * f[8] + dys * f[11] - oz
    nsq = dx * dx + dy * dy + dz * dz
    pos = nsq > 0.0
    safe = torch.where(pos, nsq, torch.ones_like(nsq))
    inv = torch.where(pos, 1.0 / torch.sqrt(safe.double()).float(),
                      torch.zeros_like(nsq))
    tm = u4 * (f[20] - f[19]) + f[19]
    return ox, oy, oz, dx * inv, dy * inv, dz * inv, tm
