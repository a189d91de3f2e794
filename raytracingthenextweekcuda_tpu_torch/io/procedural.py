"""Procedural mesh generators (numpy copy of
raytracingthenextweekcuda_tpu/io/procedural.py).

The framework ships self-contained test/bench geometry instead of depending
on external model files (the reference bundles .obj/.ply assets; capability
parity needs the loaders in io/obj.py + io/ply.py, but benchmarks and tests
must run standalone).
"""

from __future__ import annotations

import numpy as np


def cube_mesh(half_extent: float = 0.25, center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Axis-aligned cube as 12 triangles, (12, 3, 3) f32, CCW-outward.

    Same geometry as the reference's cube_small.obj (a Blender cube with
    0.25 half-extent).
    """
    h = half_extent
    c = np.asarray(center, np.float32)
    corners = np.array(
        [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)],
        np.float32,
    ) + c
    # Faces as corner indices (bit layout: x<<2 | y<<1 | z), CCW from outside.
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    tris = []
    for a, b, cc, d in quads:
        tris.append((a, b, cc))
        tris.append((a, cc, d))
    return corners[np.asarray(tris, np.int32)]


def uv_sphere_mesh(
    radius: float = 0.5, center=(0.0, 0.0, 0.0), n_lat: int = 16, n_lon: int = 32
) -> np.ndarray:
    """UV sphere triangle soup, ((2*n_lat-2)*n_lon, 3, 3) f32."""
    c = np.asarray(center, np.float32)
    theta = np.linspace(0.0, np.pi, n_lat + 1)
    phi = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    # ring[i, j] = point at latitude i, longitude j
    ring = np.stack(
        [
            st[:, None] * cp[None, :],
            ct[:, None] * np.ones_like(cp)[None, :],
            st[:, None] * sp[None, :],
        ],
        axis=-1,
    ).astype(np.float32) * radius + c

    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            jn = (j + 1) % n_lon
            a, b = ring[i, j], ring[i, jn]
            d, e = ring[i + 1, j], ring[i + 1, jn]
            if i > 0:
                tris.append((a, d, b))
            if i < n_lat - 1:
                tris.append((b, d, e))
    return np.asarray(tris, np.float32)


def write_obj(path: str, triangles: np.ndarray) -> None:
    """Write a (T, 3, 3) triangle soup as a (deduplicated) OBJ file."""
    flat = triangles.reshape(-1, 3)
    verts, inverse = np.unique(flat.round(6), axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    with open(path, "w") as f:
        f.write("# generated by raytracingthenextweekcuda_tpu_torch\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
