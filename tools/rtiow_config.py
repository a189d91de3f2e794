"""Write the benchmark's `rtiow_final` configuration as data.

    python3 tools/rtiow_config.py    # writes benchmark/configs/rtiow_final/config.json

The scene is the port's preset `presets.rtiow_final(seed=0)`, the upstream
SCENE 2 (main.cu:792-848): 22x22 random small spheres, the diffuse ones
moving over the shutter as in Ray Tracing: The Next Week ch. 2, the glass,
Lambertian and metal trio and a radius-1000 ground sphere, seen through a
thin lens. Every number is written as the shortest decimal that reads back
as the preset's float32 value, one sphere and one material a line. Runs on
the CPU; imports numpy and the port's presets.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
OUT = ROOT / "benchmark" / "configs" / "rtiow_final" / "config.json"

KIND_NAMES = ("lambertian", "metal", "dielectric", "emission",
              "phong_metal", "specular", "coat", "refraction")

HEAD = {
    "name": "rtiow_final",
    "source": ("https://github.com/erosnick/RayTracingTheNextWeekCUDA (main.cu:792-848, "
               "SCENE 2: the RTiOW final scene, diffuse spheres moving as in RTNW ch. 2; "
               "job as R. Allen, RTiOW in CUDA, NVIDIA blog)"),
    "describes": ("The Ray Tracing in One Weekend final scene as the upstream's SCENE 2 "
                  "builds it: 22x22 random spheres of radius 0.2 (80% Lambertian and "
                  "moving up by U(0, 0.5) over the shutter, 15% fuzzed metal, 5% glass), "
                  "a glass, a Lambertian and a metal sphere of radius 1 and a radius-1000 "
                  "ground sphere: 488 spheres, 488 materials. The thin-lens camera of the "
                  "book's final render. The port's presets.rtiow_final(seed=0)."),
    "reduced": [],
    "assumed": {
        "sphere_field": ("numpy default_rng(0) draws stand in for the upstream's curand "
                         "draws: the same distribution, not the same spheres"),
        "sky": "the port's gradient from white to (0.5, 0.7, 1.0), as the other configurations",
    },
    "precision": ("float32 arithmetic; sqrt, 1/sqrt, sin, cos, exp and log taken in "
                  "float64 and rounded to float32"),
}


def num(x) -> str:
    """The shortest decimal that reads back as float32 `x`."""
    return np.format_float_positional(np.float32(x), unique=True, trim="0")


def vec(v) -> str:
    return "[" + ", ".join(num(x) for x in v) + "]"


def config_text() -> str:
    from raytracingthenextweekcuda_tpu_torch.models import presets

    scene, cam = presets.rtiow_final(seed=0)
    s, m = scene.spheres, scene.materials
    lines = []
    for i in range(m.count):
        row = f'{{"id": {i}, "kind": "{KIND_NAMES[int(m.kind[i])]}", ' \
              f'"albedo": {vec(m.albedo[i])}'
        if m.param[i] != 0.0:
            row += f', "param": {num(m.param[i])}'
        lines.append(row + "}")
    prims = []
    for i in range(s.count):
        row = f'{{"type": "sphere", "center0": {vec(s.center0[i])}'
        if not np.array_equal(s.center1[i], s.center0[i]):
            row += (f', "center1": {vec(s.center1[i])}, "time0": {num(s.time0[i])}, '
                    f'"time1": {num(s.time1[i])}')
        prims.append(row + f', "radius": {num(s.radius[i])}, '
                           f'"material": {int(s.material_id[i])}}}')
    camera = {"eye": [float(num(x)) for x in cam.eye.numpy()],
              "center": [float(num(x)) for x in cam.center.numpy()],
              "up": [float(num(x)) for x in cam.up.numpy()],
              "fov": float(num(cam.fov)), "aperture": float(num(cam.aperture)),
              "focus_distance": float(num(cam.focus_distance)),
              "time0": float(num(cam.time0)), "time1": float(num(cam.time1))}
    moving = int((s.center1 != s.center0).any(axis=1).sum())
    head = dict(HEAD, spheres=int(s.count), moving_spheres=moving)
    text = json.dumps(head, indent=2)[:-2]
    text += (',\n  "scene": {\n    "camera": ' + json.dumps(camera) + ',\n'
             '    "materials": [\n      ' + ",\n      ".join(lines) + '\n    ],\n'
             '    "primitives": [\n      ' + ",\n      ".join(prims) + '\n    ]\n  }\n}\n')
    json.loads(text)
    return text


def main() -> int:
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(config_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
