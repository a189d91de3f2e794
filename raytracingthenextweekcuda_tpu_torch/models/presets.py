"""Built-in scene presets (counterpart of
raytracingthenextweekcuda_tpu/models/presets.py).

The reference hard-codes three compile-time scenes (`#define SCENE`,
main.cu:233): SCENE 0 defocus/moving-sphere (main.cu:592-622), SCENE 1
YAML-driven Cornell boxes (main.cu:623-786), SCENE 2 the RTiOW final random
spheres (main.cu:792-848). These presets reproduce them as plain functions,
plus the BASELINE benchmark configs.
"""

from __future__ import annotations

import numpy as np

from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
from raytracingthenextweekcuda_tpu_torch.models.scene import Scene, SceneBuilder
from raytracingthenextweekcuda_tpu_torch.io.procedural import cube_mesh, uv_sphere_mesh
from raytracingthenextweekcuda_tpu_torch.ops.geometry import PLANE_XY, PLANE_XZ, PLANE_YZ


def _transform(tris: np.ndarray, scale, rotate_y_deg, offset) -> np.ndarray:
    """scale -> rotateY -> offset, the YAML mesh transform (ModelLoader.cpp:438-445)."""
    v = tris.reshape(-1, 3) * np.asarray(scale, np.float32)
    rad = np.deg2rad(rotate_y_deg)
    c, s = np.cos(rad), np.sin(rad)
    out = v.copy()
    out[:, 0] = c * v[:, 0] + s * v[:, 2]
    out[:, 2] = -s * v[:, 0] + c * v[:, 2]
    return (out + np.asarray(offset, np.float32)).reshape(-1, 3, 3)


def diffuse_sphere_plane() -> tuple[Scene, Camera]:
    """BASELINE config 1: single diffuse sphere + ground plane."""
    b = SceneBuilder()
    b.lambertian(0, (0.7, 0.3, 0.3))
    b.lambertian(1, (0.8, 0.8, 0.0))
    b.sphere((0.0, 0.0, -1.0), 0.5, 0)
    b.plane((0.0, -0.5, 0.0), (0.0, 1.0, 0.0), (100.0, 0.0, 100.0), PLANE_XZ, 1)
    camera = Camera.make(
        eye=(0.0, 0.2, 1.2), center=(0.0, 0.0, -1.0), fov=60.0,
        aperture=0.0, focus_distance=1.0, time1=1.0,
    )
    return b.build(), camera


def defocus_blur() -> tuple[Scene, Camera]:
    """SCENE 0 (main.cu:592-622): glass/hollow-glass, moving lambertian,
    two metals, ground sphere; fov 20 camera focused at the scene."""
    eye = np.asarray((3.0, 3.0, 5.0), np.float32)
    center = np.asarray((0.0, 0.0, -1.0), np.float32)
    camera = Camera.make(
        eye=eye, center=center, fov=20.0, aperture=0.0,
        focus_distance=float(np.linalg.norm(center - eye)), time0=0.0, time1=1.0,
    )
    b = SceneBuilder()
    b.dielectric(0, 1.5)
    b.dielectric(1, 1.5)
    b.lambertian(2, (0.1, 0.2, 0.5))
    b.metal(3, (0.8, 0.6, 0.2), 0.0)
    b.metal(4, (0.5, 0.7, 1.0), 0.0)
    b.sphere((-1.0, 0.0, -1.0), 0.5, 0)
    b.sphere((-1.0, 0.0, -1.0), -0.4, 1)  # hollow interior
    b.moving_sphere((0.0, 0.0, -1.0), (0.0, 0.5, -1.0), 0.0, 1.0, 0.5, 2)
    b.sphere((1.0, 0.0, -1.0), 0.5, 3)
    b.sphere((0.0, -100.5, -1.0), 100.0, 4)
    return b.build(), camera


def cornell_box(
    with_spheres: bool = True, with_cubes: bool = True, light_intensity: float = 5.0
) -> tuple[Scene, Camera]:
    """The cornellbox2.yaml scene built programmatically
    (resources/scenes/cornellbox2.yaml + material table main.cu:643-651)."""
    camera = Camera.make(
        eye=(0.0, 0.0, 1.0), center=(0.0, 0.0, -1.0), fov=60.0,
        aperture=0.0, focus_distance=2.0, time0=0.0, time1=1.0,
    )
    b = SceneBuilder()
    b.lambertian(3, (1.0, 1.0, 1.0))
    b.lambertian(4, (0.75, 0.25, 0.25))
    b.lambertian(5, (0.25, 0.25, 0.75))
    b.metal(6, (1.0, 1.0, 1.0), 0.0)
    b.dielectric(7, 1.5)
    b.emission(8, (1.0, 1.0, 1.0), light_intensity)

    e = (0.5, 0.5, 0.5)
    b.plane((0.0, 0.5, 0.0), (0.0, 1.0, 0.0), e, PLANE_XZ, 3)        # top
    b.plane((0.0, -0.5, 0.0), (0.0, -1.0, 0.0), e, PLANE_XZ, 3)      # bottom
    b.plane((-0.5, 0.0, 0.0), (-1.0, 0.0, 0.0), e, PLANE_YZ, 4)      # left red
    b.plane((0.5, 0.0, 0.0), (1.0, 0.0, 0.0), e, PLANE_YZ, 5)        # right blue
    b.plane((0.0, 0.0, -0.5), (0.0, 0.0, -1.0), e, PLANE_XY, 3)      # back
    b.plane(
        (0.0, 0.49, 0.0), (0.0, 1.0, 0.0), (0.125, 0.125, 0.125),
        PLANE_XZ, 8, two_sided=False,
    )  # area light
    if with_spheres:
        b.sphere((-0.25, 0.15, -0.25), 0.15, 6)   # mirror
        b.sphere((0.25, -0.1, -0.25), 0.15, 7)    # glass
    if with_cubes:
        cube = cube_mesh(0.25)
        b.mesh(_transform(cube, (0.5, 1.0, 0.5), 30.0, (-0.25, -0.25, -0.25)), 3)
        b.mesh(_transform(cube, (0.5, 0.5, 0.5), -30.0, (0.25, -0.375, -0.25)), 3)
    return b.build(), camera


def rtiow_final(seed: int = 0) -> tuple[Scene, Camera]:
    """SCENE 2 (main.cu:792-848): the RTiOW 'final render' — 22x22 random
    small spheres (diffuse ones motion-blurred) + glass/lambert/metal trio +
    ground sphere."""
    rng = np.random.default_rng(seed)
    camera = Camera.make(
        eye=(13.0, 2.0, 3.0), center=(0.0, 0.0, 0.0), fov=20.0,
        aperture=0.1, focus_distance=10.0, time0=0.0, time1=1.0,
    )
    b = SceneBuilder()
    mid = 0
    for a in range(-11, 11):
        for gz in range(-11, 11):
            choose = rng.random()
            center = np.asarray(
                [a + 0.9 * rng.random(), 0.2, gz + 0.9 * rng.random()], np.float32
            )
            if np.linalg.norm(center - np.asarray([4.0, 0.2, 0.0])) <= 0.9:
                albedo = rng.random(3) * rng.random(3)
                b.lambertian(mid, tuple(albedo))
                b.sphere(center, 0.2, mid)
            elif choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                b.lambertian(mid, tuple(albedo))
                center1 = center + np.asarray([0.0, rng.uniform(0.0, 0.5), 0.0], np.float32)
                b.moving_sphere(center, center1, 0.0, 1.0, 0.2, mid)
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                b.metal(mid, tuple(albedo), rng.uniform(0.0, 0.5))
                b.sphere(center, 0.2, mid)
            else:
                b.dielectric(mid, 1.5)
                b.sphere(center, 0.2, mid)
            mid += 1
    b.lambertian(mid, (0.5, 0.5, 0.5)); b.sphere((0.0, -1000.0, 0.0), 1000.0, mid); mid += 1
    b.dielectric(mid, 1.5); b.sphere((0.0, 1.0, 0.0), 1.0, mid); mid += 1
    b.lambertian(mid, (0.4, 0.2, 0.1)); b.sphere((-4.0, 1.0, 0.0), 1.0, mid); mid += 1
    b.metal(mid, (0.7, 0.6, 0.5), 0.0); b.sphere((4.0, 1.0, 0.0), 1.0, mid); mid += 1
    return b.build(), camera


def smallpt_spheres(with_mesh: bool = False) -> tuple[Scene, Camera]:
    """Path B's hard-coded device sphere array (CUDAPathTracer.cu:94-121):
    emissive sun, sky dome, double-shell ground (COAT over DIFFUSE),
    horizon brightener, specular mirror ball. These spheres emit additively
    and keep scattering — the Path B material model. Optionally adds the
    materialball-style mesh (a procedural stand-in) with COAT, mirroring
    prepareCUDAscene's PLY load (main.cu:428-430)."""
    b = SceneBuilder()
    # id: (kind factory, albedo/color, emission)
    b.material(0, 0, (0.0, 0.0, 0.0), 0.0, emission=(6.0, 4.0, 2.0))      # sun
    b.material(1, 0, (0.175, 0.175, 0.25), 0.0, emission=(0.51, 0.51, 0.51))  # sky
    b.coat(2, (0.5, 0.0, 0.0))                                            # ground shell
    b.lambertian(3, (0.3, 0.3, 0.3))                                      # under-shell
    b.material(4, 0, (0.0, 0.0, 0.0), 0.0, emission=(3.6, 2.0, 0.2))      # horizon
    b.specular(5, (0.9, 0.9, 0.9))                                        # mirror
    b.coat(6, (0.9, 0.3, 0.0))                                            # mesh

    b.sphere((0.0, 2.8, 0.0), 1.6, 0)
    b.sphere((50.0, 40.8, -1060.0), 10000.0, 1)
    b.sphere((0.0, -100001.1, 0.0), 100000.0, 2)
    b.sphere((0.0, -100001.2, 0.0), 100000.0, 3)
    b.sphere((50.0, -110048.5, 0.0), 110000.0, 4)
    b.sphere((1.6, 0.0, 1.0), 1.1, 5)
    if with_mesh:
        b.mesh(uv_sphere_mesh(0.8, (-1.5, -0.2, -1.0), 16, 32), 6)

    camera = Camera.make(
        eye=(0.0, 0.2, 4.0), center=(0.0, 0.2, -1.0), fov=60.0,
        aperture=0.0, focus_distance=5.0, time1=1.0,
    )
    return b.build(), camera


def mesh_showcase(n_lat: int = 24, n_lon: int = 48) -> tuple[Scene, Camera]:
    """Procedural stand-in for the bunny/materialball BVH config: a dense
    UV-sphere mesh under the Cornell light, for mesh/BVH benchmarking without
    external assets."""
    scene_b = SceneBuilder()
    scene_b.lambertian(0, (0.73, 0.73, 0.73))
    scene_b.coat(1, (0.9, 0.3, 0.0))
    scene_b.emission(2, (1.0, 1.0, 1.0), 4.0)
    scene_b.plane((0.0, -0.5, 0.0), (0.0, 1.0, 0.0), (3.0, 0.0, 3.0), PLANE_XZ, 0)
    scene_b.plane(
        (0.0, 1.2, 0.0), (0.0, 1.0, 0.0), (0.8, 0.8, 0.8), PLANE_XZ, 2,
        two_sided=False,
    )
    mesh = uv_sphere_mesh(0.45, (0.0, 0.0, -0.3), n_lat, n_lon)
    scene_b.mesh(mesh, 1)
    camera = Camera.make(
        eye=(0.0, 0.3, 1.6), center=(0.0, 0.0, -0.3), fov=50.0,
        aperture=0.0, focus_distance=1.9, time1=1.0,
    )
    return scene_b.build(), camera
