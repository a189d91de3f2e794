"""Primitive struct-of-arrays containers and material kinds (counterpart of
raytracingthenextweekcuda_tpu/ops/geometry.py).

Scenes are built and packed on the host, so the containers hold numpy
arrays; the packed rows go to the device once per render pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Material kinds: the union of Path A's MaterialType and Path B's
# ReflectionType; the values are the reference's.
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSION = 3
PHONG_METAL = 4   # Phong lobe, exponent in `param`
SPECULAR = 5      # perfect mirror
COAT = 6          # 5% specular else diffuse
REFRACTION = 7    # smallpt-style glass with RP/TP weights
NUM_MATERIAL_KINDS = 8

# Plane orientation: which two axes the finite extent spans.
PLANE_XY = 0
PLANE_YZ = 1
PLANE_XZ = 2


@dataclasses.dataclass(frozen=True)
class Materials:
    """Material table of M rows. `param` is fuzz (METAL), IOR (DIELECTRIC,
    REFRACTION), intensity (EMISSION) or Phong exponent (PHONG_METAL);
    `emission` is Path B's additive per-hit radiance."""

    kind: np.ndarray      # (M,) int32
    albedo: np.ndarray    # (M, 3) float32
    param: np.ndarray     # (M,) float32
    emission: np.ndarray  # (M, 3) float32

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass(frozen=True)
class Spheres:
    """S spheres; a static sphere has center0 == center1. Negative radii
    flip the normals inward (hollow glass)."""

    center0: np.ndarray      # (S, 3)
    center1: np.ndarray      # (S, 3)
    time0: np.ndarray        # (S,)
    time1: np.ndarray        # (S,), != time0
    radius: np.ndarray       # (S,)
    material_id: np.ndarray  # (S,) int32

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass(frozen=True)
class Planes:
    """P finite axis-oriented planes."""

    position: np.ndarray     # (P, 3)
    normal: np.ndarray       # (P, 3) unit
    extend: np.ndarray       # (P, 3) half extents
    orientation: np.ndarray  # (P,) int32 in {XY, YZ, XZ}
    two_sided: np.ndarray    # (P,) bool
    material_id: np.ndarray  # (P,) int32

    @property
    def count(self) -> int:
        return self.position.shape[0]


@dataclasses.dataclass(frozen=True)
class Triangles:
    """T triangles as a (T, 3, 3) vertex array."""

    vertices: np.ndarray     # (T, 3, 3) [tri, corner, xyz]
    material_id: np.ndarray  # (T,) int32
    mesh_id: np.ndarray      # (T,) int32

    @property
    def count(self) -> int:
        return self.vertices.shape[0]


def empty_spheres() -> Spheres:
    z3 = np.zeros((0, 3), np.float32)
    z = np.zeros((0,), np.float32)
    return Spheres(z3, z3, z, np.ones((0,), np.float32), z,
                   np.zeros((0,), np.int32))


def empty_planes() -> Planes:
    z3 = np.zeros((0, 3), np.float32)
    zi = np.zeros((0,), np.int32)
    return Planes(z3, z3, z3, zi, np.zeros((0,), bool), zi)


def empty_triangles() -> Triangles:
    return Triangles(np.zeros((0, 3, 3), np.float32),
                     np.zeros((0,), np.int32), np.zeros((0,), np.int32))


def empty_materials() -> Materials:
    return Materials(kind=np.zeros((1,), np.int32),
                     albedo=np.zeros((1, 3), np.float32),
                     param=np.zeros((1,), np.float32),
                     emission=np.zeros((1, 3), np.float32))
