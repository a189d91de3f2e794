"""Scene data of the benchmark's configurations, read from their files.

A configuration's file (`configs/<name>/config.json`) holds its scene as
data: the camera, the material table and a list of primitives. A mesh is
made by a frozen generator named in the file (`cube`, `uv_sphere`) with a
transform, or read from a `.npy` file beside the config (`file`). This
module makes the raw arrays; both sides get the same arrays: the program
through its public `SceneBuilder` (program.py), the plain reference
through its own reader (`reference/pathtracer.build_scene`). Nothing here
imports the program.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

BENCH_DIR = pathlib.Path(__file__).resolve().parent
CONFIG_DIR = BENCH_DIR / "configs"

# Material kinds, as the program's material table numbers them.
KINDS = {"lambertian": 0, "metal": 1, "dielectric": 2, "emission": 3,
         "phong_metal": 4, "specular": 5, "coat": 6, "refraction": 7}
# Plane orientation: which two axes the finite extent spans.
ORIENTATIONS = {"xy": 0, "yz": 1, "xz": 2}


def config_path(name: str) -> pathlib.Path:
    return CONFIG_DIR / name / "config.json"


def load_config(name: str) -> dict:
    """The configuration file of `name`, with its folder under `_dir`."""
    path = config_path(name)
    if not path.is_file():
        raise FileNotFoundError(f"no configuration file {path}")
    cfg = json.loads(path.read_text())
    cfg["_dir"] = str(path.parent)
    return cfg


# -- frozen mesh generators ---------------------------------------------------

def cube_mesh(half_extent: float = 0.25) -> np.ndarray:
    """Axis-aligned cube, 12 triangles (12, 3, 3) float32, wound
    counter-clockwise seen from outside (the upstream cube_small.obj)."""
    h = half_extent
    corners = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                        for z in (-h, h)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris.append((a, b, c))
        tris.append((a, c, d))
    return corners[np.asarray(tris, np.int32)]


def uv_sphere_mesh(radius: float, center, n_lat: int, n_lon: int) -> np.ndarray:
    """UV-sphere triangle soup, ((2 n_lat - 2) n_lon, 3, 3) float32, wound
    so that the front faces look out."""
    c = np.asarray(center, np.float32)
    theta = np.linspace(0.0, np.pi, n_lat + 1)
    phi = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    ring = np.stack([st[:, None] * cp[None, :],
                     ct[:, None] * np.ones_like(cp)[None, :],
                     st[:, None] * sp[None, :]], axis=-1
                    ).astype(np.float32) * radius + c
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            jn = (j + 1) % n_lon
            a, b = ring[i, j], ring[i, jn]
            d, e = ring[i + 1, j], ring[i + 1, jn]
            if i > 0:
                tris.append((b, d, a))
            if i < n_lat - 1:
                tris.append((e, d, b))
    return np.asarray(tris, np.float32)


def transform(tris: np.ndarray, scale, rotate_y_deg: float, offset) -> np.ndarray:
    """scale, then rotate about +y, then offset (the upstream YAML mesh
    transform, ModelLoader.cpp:438-445)."""
    v = tris.reshape(-1, 3) * np.asarray(scale, np.float32)
    rad = np.deg2rad(rotate_y_deg)
    c, s = np.cos(rad), np.sin(rad)
    out = v.copy()
    out[:, 0] = c * v[:, 0] + s * v[:, 2]
    out[:, 2] = -s * v[:, 0] + c * v[:, 2]
    return (out + np.asarray(offset, np.float32)).reshape(-1, 3, 3)


GENERATORS = {
    "cube": lambda p: cube_mesh(p.get("half_extent", 0.25)),
    "uv_sphere": lambda p: uv_sphere_mesh(p["radius"], p["center"],
                                          p["n_lat"], p["n_lon"]),
}


def mesh_vertices(prim: dict, config_dir: str) -> np.ndarray:
    """(T, 3, 3) float32 vertices of a `mesh` primitive."""
    if "file" in prim:
        tris = np.load(pathlib.Path(config_dir) / prim["file"]).astype(np.float32)
    else:
        tris = GENERATORS[prim["generator"]](prim.get("params", {}))
    tris = tris.reshape(-1, 3, 3)
    if "transform" in prim:
        t = prim["transform"]
        tris = transform(tris, t.get("scale", (1.0, 1.0, 1.0)),
                         t.get("rotate_y", 0.0), t.get("offset", (0.0, 0.0, 0.0)))
    return np.ascontiguousarray(tris, np.float32)


def scene_meshes(cfg: dict) -> list[tuple[np.ndarray, int]]:
    """(vertices, material id) of every mesh primitive, in file order."""
    return [(mesh_vertices(p, cfg["_dir"]), int(p["material"]))
            for p in cfg["scene"]["primitives"] if p["type"] == "mesh"]
