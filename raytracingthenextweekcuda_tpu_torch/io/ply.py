"""ASCII PLY loader and mesh normalization (numpy copy of
raytracingthenextweekcuda_tpu/io/ply.py).

Replaces Loader.cpp's minimal "shadevis-style" PLY parser (Loader.cpp:207-319)
and its processTriangleData normalization (Loader.cpp:98-205). Handles the
Blender-exported layout the reference assets use: float vertex properties
starting with x y z (extra normals/UVs ignored) and uchar-counted face lists,
fan-triangulated.
"""

from __future__ import annotations

import numpy as np


def parse_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse ASCII PLY -> (positions (V, 3) f32, faces (F, 3) int32)."""
    with open(path, "r", errors="replace") as f:
        line = f.readline().strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file")
        n_vertices = n_faces = 0
        fmt = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            line = line.strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vertices = int(line.split()[2])
            elif line.startswith("element face"):
                n_faces = int(line.split()[2])
            elif line == "end_header":
                break
        if fmt != "ascii":
            raise ValueError(f"{path}: only ascii PLY supported (got {fmt})")

        positions = np.empty((n_vertices, 3), np.float32)
        for i in range(n_vertices):
            parts = f.readline().split()
            positions[i] = (float(parts[0]), float(parts[1]), float(parts[2]))

        faces: list[tuple[int, int, int]] = []
        for _ in range(n_faces):
            parts = f.readline().split()
            count = int(parts[0])
            idx = [int(p) for p in parts[1 : 1 + count]]
            for k in range(1, count - 1):
                faces.append((idx[0], idx[k], idx[k + 1]))
    return positions, np.asarray(faces, np.int32).reshape(-1, 3)


def normalize_mesh(
    positions: np.ndarray, offset=(0.0, 0.0, 0.0), max_coord: float = 1.0
) -> np.ndarray:
    """Center at origin, uniform-scale so max |coord| == max_coord, then
    translate by offset: processTriangleData (Loader.cpp:104-150)."""
    lo = positions.min(axis=0)
    hi = positions.max(axis=0)
    center = (lo + hi) * 0.5
    centered = positions - center
    maxi = np.abs(centered).max()
    if maxi > 0:
        centered = centered * (max_coord / maxi)
    return (centered + np.asarray(offset, np.float32)).astype(np.float32)


def load_ply(
    path: str,
    offset=(0.0, 0.0, 0.0),
    normalize: bool = True,
    max_coord: float = 1.0,
    prefer_native: bool = True,
) -> np.ndarray:
    """Load a PLY as a (T, 3, 3) triangle tensor.

    `normalize=True` applies the reference's center/scale/offset pipeline
    (prepareCUDAscene does this for every PLY, main.cu:430-432).

    Uses the native C++ parser (native/asset_loader.cpp) when its library
    is there; it also reads binary_little_endian PLY. This Python parser is
    the ascii fallback and the test oracle.
    """
    if prefer_native:
        from raytracingthenextweekcuda_tpu_torch import native

        if native.loaders_available():
            return native.load_ply_native(path, offset, normalize, max_coord)
    positions, faces = parse_ply(path)
    if normalize:
        positions = normalize_mesh(positions, offset, max_coord)
    else:
        positions = positions + np.asarray(offset, np.float32)
    return positions[faces]
