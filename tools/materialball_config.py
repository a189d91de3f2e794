"""Write the benchmark's `materialball_x48` configuration as data.

    python3 tools/materialball_config.py   # writes benchmark/configs/materialball_x48/config.json

The scene is the `mesh_stress` configuration (the upstream cornellbox2.yaml
with materialball.ply, main.cu:428-432) with its one ball replaced by 48
copies laid out as the repository's large-scene job, `large_mesh_scene` of
the JAX package (apps/bench_scenes.py): each ball moved by (0, 0, -1),
scaled by 0.45 and offset on a 7 x 7 grid, x = -0.6 + 1.2 gx / 6,
y = -0.25 + 0.5 gy / 6, z = 0.35 U(-1, 1) drawn in copy order from
numpy's default_rng(7). Each copy is the `mesh_stress` stand-in ball (a
UV sphere of radius 1 at the origin, 113 x 209) with the transform scale
0.45 and offset (x, y, z - 0.45): the rule's move by (0, 0, -1) before the
scale is that offset's -0.45. Every number is written as the shortest
decimal that reads back as its float32 value (tools/rtiow_config.num).
Runs on the CPU; imports numpy only.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from tools.rtiow_config import num  # noqa: E402

BASE = ROOT / "benchmark" / "configs" / "mesh_stress" / "config.json"
OUT = ROOT / "benchmark" / "configs" / "materialball_x48" / "config.json"

COPIES = 48
SCALE = 0.45
LAYOUT_SEED = 7
BALL = {"radius": 1.0, "center": [0.0, 0.0, 0.0], "n_lat": 113, "n_lon": 209}
BALL_TRIANGLES = (2 * BALL["n_lat"] - 2) * BALL["n_lon"]

HEAD = {
    "name": "materialball_x48",
    "source": ("erosnick/RayTracingTheNextWeekCUDA cornellbox2.yaml + materialball.ply "
               "(main.cu:428-432), 48 copies as large_mesh_scene "
               "(raytracingthenextweekcuda_tpu/apps/bench_scenes.py:101-139)"),
    "describes": ("The upstream mesh scene at production size: the cornellbox2 scene of "
                  "the mesh_stress configuration (walls, light, two spheres, two boxes, "
                  "camera, materials) with 48 coat materialballs, each moved by "
                  "(0, 0, -1), scaled by 0.45 and placed on a 7 x 7 grid with a seeded "
                  "depth jitter, as the repository's large-scene job lays them out: "
                  "2,247,192 triangles, past the 2,048-leaf line of the work lists' "
                  "packet-frustum pass."),
    "reduced": [],
    "published": {"copies": COPIES, "triangles": COPIES * BALL_TRIANGLES},
    "assumed": {
        "mesh": ("each copy is the mesh_stress stand-in for materialball.ply: "
                 "uv_sphere(1.0, (0, 0, 0), 113, 209), 46,816 triangles wound outward; "
                 "the asset is not in the repository"),
        "layout": ("large_mesh_scene(48): grid 7, x = -0.6 + 1.2 gx / 6, "
                   "y = -0.25 + 0.5 gy / 6, z = 0.35 U(-1, 1) from numpy "
                   "default_rng(7) in copy order, gx = i % 7, gy = i // 7; the ball "
                   "moved by (0, 0, -1) and scaled by 0.45 before the offset, written "
                   "as scale 0.45 and offset (x, y, z - 0.45)"),
        "spp": ("16 samples a pixel in one pass of 16, which fills the sorted "
                "wavefront's 4.19 M-ray cap (the README's large row ran 8)"),
    },
    "precision": ("float32 arithmetic; sqrt, 1/sqrt, sin, cos, exp and log taken in "
                  "float64 and rounded to float32"),
}


def offsets(copies: int = COPIES) -> np.ndarray:
    """(copies, 3) float32: each copy's offset after the 0.45 scale, the
    layout rule's grid and jitter plus the rule's (0, 0, -1) move scaled."""
    rng = np.random.default_rng(LAYOUT_SEED)
    grid = math.ceil(math.sqrt(copies))
    out = []
    for i in range(copies):
        gx, gy = i % grid, i // grid
        off = np.array([-0.6 + 1.2 * gx / max(grid - 1, 1),
                        -0.25 + 0.5 * gy / max(grid - 1, 1),
                        0.35 * rng.uniform(-1.0, 1.0)], np.float32)
        out.append(off + np.float32(SCALE) * np.float32([0.0, 0.0, -1.0]))
    return np.stack(out)


def config_text() -> str:
    base = json.loads(BASE.read_text())
    scene = base["scene"]
    prims = [p for p in scene["primitives"]
             if not (p["type"] == "mesh" and p.get("generator") == "uv_sphere")]
    ball = json.dumps({"generator": "uv_sphere", "params": BALL})[1:-1]
    balls = [f'{{"type": "mesh", {ball}, "transform": {{"scale": '
             f'[{num(SCALE)}, {num(SCALE)}, {num(SCALE)}], "offset": '
             f'[{", ".join(num(x) for x in off)}]}}, "material": 20}}'
             for off in offsets()]
    boxes = sum(12 for p in prims if p["type"] == "mesh")
    head = dict(HEAD, triangles=boxes + COPIES * BALL_TRIANGLES)
    text = json.dumps(head, indent=2)[:-2]
    text += (',\n  "scene": {\n    "camera": ' + json.dumps(scene["camera"]) + ',\n'
             '    "materials": [\n      '
             + ",\n      ".join(json.dumps(m) for m in scene["materials"]) + '\n    ],\n'
             '    "primitives": [\n      '
             + ",\n      ".join([json.dumps(p) for p in prims] + balls)
             + '\n    ]\n  }\n}\n')
    json.loads(text)
    return text


def main() -> int:
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(config_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
