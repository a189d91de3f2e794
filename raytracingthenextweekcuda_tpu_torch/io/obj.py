"""Wavefront OBJ loader (numpy copy of raytracingthenextweekcuda_tpu/io/obj.py).

Replaces the tinyobjloader-based ModelLoader (ModelLoader.cpp:275-448) with a
minimal parser: `v` positions and `f` faces (fan-triangulated, 1-based and
negative indices, `v/vt/vn` forms). The per-vertex transform matches
loadModel's scale -> rotateY(degrees) -> offset order (ModelLoader.cpp:438-445).
"""

from __future__ import annotations

import numpy as np


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse OBJ -> (positions (V, 3) f32, faces (F, 3) int32)."""
    positions: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for token in line.split()[1:]:
                    i = int(token.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                # Fan triangulation of polygons (tinyobjloader's default).
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (
        np.asarray(positions, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 3),
    )


def _rotate_y(v: np.ndarray, degrees: float) -> np.ndarray:
    rad = np.deg2rad(degrees)
    c, s = np.cos(rad), np.sin(rad)
    out = v.copy()
    out[:, 0] = c * v[:, 0] + s * v[:, 2]
    out[:, 2] = -s * v[:, 0] + c * v[:, 2]
    return out


def load_obj(
    path: str,
    scale=(1.0, 1.0, 1.0),
    rotate=(0.0, 0.0, 0.0),
    offset=(0.0, 0.0, 0.0),
    prefer_native: bool = True,
) -> np.ndarray:
    """Load an OBJ as a (T, 3, 3) triangle tensor with the reference's
    per-vertex transform: v *= scale; v = rotateY(v, rotate.y); v += offset
    (ModelLoader.cpp:438-445; only the Y component of `rotate` is used,
    as in the reference).

    Uses the native C++ parser (native/asset_loader.cpp) when its library
    is there; this Python parser is the fallback and the test oracle."""
    if prefer_native:
        from raytracingthenextweekcuda_tpu_torch import native

        if native.loaders_available():
            return native.load_obj_native(path, scale, rotate, offset)
    positions, faces = parse_obj(path)
    v = positions * np.asarray(scale, np.float32)
    v = _rotate_y(v, float(np.asarray(rotate, np.float32)[1]))
    v = v + np.asarray(offset, np.float32)
    return v[faces]  # (T, 3, 3)
