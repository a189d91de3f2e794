"""Scene container and host-side builder (counterpart of
raytracingthenextweekcuda_tpu/models/scene.py).

`SceneBuilder` accumulates primitives and materials in host lists and
`build()` packs them once into numpy struct-of-arrays. `finalize` adds the
packed rows the render kernel reads. `from_jax_arrays` takes the leaves of
a reference Scene, as numpy arrays, so a scene built by the JAX package can
be rendered by the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from raytracingthenextweekcuda_tpu_torch.ops import geometry as geom
from raytracingthenextweekcuda_tpu_torch.ops.geometry import (
    Materials,
    Planes,
    Spheres,
    Triangles,
)


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Per-mesh AABBs."""

    bounds_min: np.ndarray  # (K, 3)
    bounds_max: np.ndarray  # (K, 3)


@dataclasses.dataclass(frozen=True)
class Scene:
    spheres: Spheres
    planes: Planes
    triangles: Triangles
    materials: Materials
    mesh_info: MeshInfo
    # PackedScene of the render kernel (ops/cuda/bounce_kernel.py).
    packed: Optional[object] = None


def finalize(scene: Scene, use_bvh: bool | None = None,
             bvh_threshold: int = 256) -> Scene:
    """Pack a built scene for the render kernel.

    `use_bvh=None` auto-selects brute force below `bvh_threshold`
    triangles and a tile-BVH above, as the reference does. The tile-BVH
    path is not ported yet and raises.
    """
    if use_bvh is None:
        use_bvh = scene.triangles.count > bvh_threshold
    if use_bvh and scene.triangles.count >= 2:
        raise NotImplementedError("tile-BVH scenes: ROADMAP queue 1 item 6")
    from raytracingthenextweekcuda_tpu_torch.ops.cuda.bounce_kernel import (
        pack_scene_shaded,
    )

    return dataclasses.replace(scene, packed=pack_scene_shaded(scene))


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _i32(x) -> np.ndarray:
    return np.asarray(x, np.int32)


def from_jax_arrays(arrays: dict[str, np.ndarray]) -> Scene:
    """A Scene from a reference Scene's leaves, keyed "<part>.<field>"
    (e.g. "spheres.center0", "materials.kind", "mesh_info.bounds_min").
    The result is unpacked: call `finalize` on it."""
    def part(cls, name, conv):
        return cls(**{f.name: conv[f.name](arrays[f"{name}.{f.name}"])
                      for f in dataclasses.fields(cls)})

    return Scene(
        spheres=part(Spheres, "spheres", dict(
            center0=_f32, center1=_f32, time0=_f32, time1=_f32, radius=_f32,
            material_id=_i32)),
        planes=part(Planes, "planes", dict(
            position=_f32, normal=_f32, extend=_f32, orientation=_i32,
            two_sided=lambda x: np.asarray(x, bool), material_id=_i32)),
        triangles=part(Triangles, "triangles", dict(
            vertices=lambda x: _f32(x).reshape(-1, 3, 3), material_id=_i32,
            mesh_id=_i32)),
        materials=part(Materials, "materials", dict(
            kind=_i32, albedo=_f32, param=_f32, emission=_f32)),
        mesh_info=MeshInfo(
            _f32(arrays.get("mesh_info.bounds_min", np.zeros((0, 3)))),
            _f32(arrays.get("mesh_info.bounds_max", np.zeros((0, 3))))),
    )


class SceneBuilder:
    """Accumulates primitives and materials, then packs the Scene."""

    def __init__(self) -> None:
        self._spheres: list[tuple] = []
        self._planes: list[tuple] = []
        self._tri_vertices: list[np.ndarray] = []
        self._tri_material: list[np.ndarray] = []
        self._tri_mesh_id: list[np.ndarray] = []
        self._materials: dict[int, tuple] = {}
        self._mesh_count = 0

    # -- materials ---------------------------------------------------------
    def material(self, material_id: int, kind: int, albedo=(0.0, 0.0, 0.0),
                 param: float = 0.0, emission=(0.0, 0.0, 0.0)) -> int:
        """Register material row `material_id`; the first definition wins.
        `emission` is additive per-hit radiance; the path keeps bouncing."""
        if material_id not in self._materials:
            self._materials[material_id] = (
                kind, tuple(albedo), float(param), tuple(emission)
            )
        return material_id

    def lambertian(self, material_id: int, albedo) -> int:
        return self.material(material_id, geom.LAMBERTIAN, albedo)

    def metal(self, material_id: int, albedo, fuzz: float = 1.0) -> int:
        return self.material(material_id, geom.METAL, albedo, min(fuzz, 1.0))

    def dielectric(self, material_id: int, ior: float) -> int:
        return self.material(material_id, geom.DIELECTRIC, (1.0, 1.0, 1.0), ior)

    def emission(self, material_id: int, albedo, intensity: float = 1.0) -> int:
        return self.material(material_id, geom.EMISSION, albedo, intensity)

    def phong_metal(self, material_id: int, albedo, exponent: float = 20.0) -> int:
        return self.material(material_id, geom.PHONG_METAL, albedo, exponent)

    def specular(self, material_id: int, albedo) -> int:
        return self.material(material_id, geom.SPECULAR, albedo)

    def coat(self, material_id: int, albedo) -> int:
        return self.material(material_id, geom.COAT, albedo)

    def refraction(self, material_id: int, ior: float = 1.5) -> int:
        """Path B smallpt-style glass."""
        return self.material(material_id, geom.REFRACTION, (1.0, 1.0, 1.0), ior)

    # -- primitives ----------------------------------------------------------
    def sphere(self, center, radius: float, material_id: int) -> None:
        """Static sphere; a negative radius makes it hollow."""
        c = tuple(center)
        self._spheres.append((c, c, 0.0, 1.0, float(radius), material_id))

    def moving_sphere(self, center0, center1, time0: float, time1: float,
                      radius: float, material_id: int) -> None:
        """Motion-blurred sphere."""
        if time1 == time0:
            time1 = time0 + 1.0  # avoid 0/0 in the center lerp
        self._spheres.append((tuple(center0), tuple(center1), float(time0),
                              float(time1), float(radius), material_id))

    def plane(self, position, normal, extend, orientation: int,
              material_id: int, two_sided: bool = True) -> None:
        """Finite oriented plane."""
        self._planes.append((tuple(position), tuple(normal), tuple(extend),
                             int(orientation), bool(two_sided), material_id))

    def cube(self, center, extend, material_id: int) -> None:
        """Cube = 6 one-sided planes at center +- extend."""
        cx, cy, cz = center
        ex, ey, ez = extend
        e = (ex, ey, ez)
        self.plane((cx - ex, cy, cz), (-1.0, 0.0, 0.0), e, geom.PLANE_YZ, material_id)
        self.plane((cx + ex, cy, cz), (1.0, 0.0, 0.0), e, geom.PLANE_YZ, material_id)
        self.plane((cx, cy + ey, cz), (0.0, 1.0, 0.0), e, geom.PLANE_XZ, material_id)
        self.plane((cx, cy - ey, cz), (0.0, -1.0, 0.0), e, geom.PLANE_XZ, material_id)
        self.plane((cx, cy, cz + ez), (0.0, 0.0, 1.0), e, geom.PLANE_XY, material_id)
        self.plane((cx, cy, cz - ez), (0.0, 0.0, -1.0), e, geom.PLANE_XY, material_id)

    def mesh(self, vertices: np.ndarray, material_id: int) -> int:
        """Triangle mesh from a (T, 3, 3) float array; returns its mesh id."""
        vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3, 3)
        t = vertices.shape[0]
        mesh_id = self._mesh_count
        self._mesh_count += 1
        self._tri_vertices.append(vertices)
        self._tri_material.append(np.full((t,), material_id, np.int32))
        self._tri_mesh_id.append(np.full((t,), mesh_id, np.int32))
        return mesh_id

    # -- packing -------------------------------------------------------------
    def build(self) -> Scene:
        if self._spheres:
            c0, c1, t0, t1, r, m = zip(*self._spheres)
            spheres = Spheres(_f32(c0), _f32(c1), _f32(t0), _f32(t1), _f32(r),
                              _i32(m))
        else:
            spheres = geom.empty_spheres()

        if self._planes:
            p, n, e, o, ts, m = zip(*self._planes)
            planes = Planes(_f32(p), _f32(n), _f32(e), _i32(o),
                            np.asarray(ts, bool), _i32(m))
        else:
            planes = geom.empty_planes()

        if self._tri_vertices:
            triangles = Triangles(
                _f32(np.concatenate(self._tri_vertices, axis=0)),
                _i32(np.concatenate(self._tri_material)),
                _i32(np.concatenate(self._tri_mesh_id)),
            )
            mesh_info = MeshInfo(
                _f32([v.reshape(-1, 3).min(axis=0) for v in self._tri_vertices]),
                _f32([v.reshape(-1, 3).max(axis=0) for v in self._tri_vertices]),
            )
        else:
            triangles = geom.empty_triangles()
            mesh_info = MeshInfo(np.zeros((0, 3), np.float32),
                                 np.zeros((0, 3), np.float32))

        if self._materials:
            max_id = max(self._materials) + 1
            kind = np.zeros((max_id,), np.int32)
            albedo = np.zeros((max_id, 3), np.float32)
            param = np.zeros((max_id,), np.float32)
            emission = np.zeros((max_id, 3), np.float32)
            for mid, (k, a, p, e) in self._materials.items():
                kind[mid], albedo[mid], param[mid], emission[mid] = k, a, p, e
            materials = Materials(kind, albedo, param, emission)
        else:
            materials = geom.empty_materials()

        return Scene(spheres=spheres, planes=planes, triangles=triangles,
                     materials=materials, mesh_info=mesh_info)
