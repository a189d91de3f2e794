"""The port's plain torch intersects (ops/intersect.py) against the JAX
reference's (its ops/intersect.py), on random scenes and rays made with
numpy: moving spheres (one hollow), finite planes of all three
orientations, one- and two-sided, and a triangle soup with back faces
culled or not. Hit t and normals at rtol = atol = 1e-4 (both are float32
with correctly rounded sqrt; XLA contracts FMAs), the hit flags, front
faces and material ids exactly. Also `integrator.intersect_scene`'s
regimes, with and without an LBVH.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracingthenextweekcuda_tpu.models.scene import SceneBuilder as JBuilder
from raytracingthenextweekcuda_tpu.ops import intersect as jintersect
from raytracingthenextweekcuda_tpu.ops.rays import Rays as JRays
from raytracingthenextweekcuda_tpu_torch.config import EPSILON, INFINITY
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    Scene,
    finalize,
    from_jax_arrays,
)
from raytracingthenextweekcuda_tpu_torch.ops import intersect
from raytracingthenextweekcuda_tpu_torch.ops.bvh import build_bvh
from raytracingthenextweekcuda_tpu_torch.ops.rays import Hit, Rays, closer


def _random_scene(seed: int):
    """(reference Scene, port Scene) with the same leaves."""
    gen = np.random.default_rng(seed)
    b = JBuilder()
    for m in range(4):
        b.lambertian(m, tuple(gen.uniform(0.1, 0.9, 3)))
    for i in range(12):
        c0 = gen.uniform(-2, 2, 3)
        c1 = c0 + (gen.uniform(-0.5, 0.5, 3) if i % 2 else 0.0)
        r = float(gen.uniform(0.2, 0.6)) * (-1.0 if i == 5 else 1.0)
        b.moving_sphere(c0, c1, 0.0, 1.0, r, i % 4)
    for i in range(9):
        orient = i % 3
        normal = np.eye(3)[[2, 0, 1][orient]] * (1 if i % 2 else -1)
        extend = np.where(normal != 0, 0.0, gen.uniform(0.5, 1.5, 3))
        b.plane(gen.uniform(-2, 2, 3), normal, extend, orient, i % 4,
                two_sided=bool(i % 4))
    tri = gen.uniform(-2, 2, (40, 1, 3)) + gen.uniform(-0.6, 0.6, (40, 3, 3))
    b.mesh(tri.astype(np.float32), 2)
    jscene = b.build()
    arrays = {f"{part}.{field}": np.asarray(getattr(getattr(jscene, part), field))
              for part in ("spheres", "planes", "triangles", "materials",
                           "mesh_info")
              for field in getattr(jscene, part)._fields}
    return jscene, from_jax_arrays(arrays)


def _random_rays(seed: int, n: int = 2048):
    gen = np.random.default_rng(seed + 100)
    o = gen.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = gen.uniform(0, 1, n).astype(np.float32)
    return (JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)),
            Rays(*(torch.from_numpy(x) for x in (o, d, tm))))


def _assert_hits_equal(ref, out):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    np.testing.assert_array_equal(out.front_face.numpy(), np.asarray(ref.front_face))
    np.testing.assert_array_equal(out.material_id.numpy(), np.asarray(ref.material_id))
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.normal.numpy(), np.asarray(ref.normal),
                               rtol=1e-4, atol=1e-4)
    return valid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["spheres", "planes", "triangles", "triangles_two_sided"])
def test_intersect_matches_reference(kind, seed):
    jscene, tscene = _random_scene(seed)
    jrays, rays = _random_rays(seed)
    tmax = 4.0 if seed else INFINITY  # a finite tmax cuts some hits
    if kind == "spheres":
        ref = jintersect.intersect_spheres(jrays, jscene.spheres, EPSILON, tmax)
        out = intersect.intersect_spheres(rays, tscene.spheres, EPSILON, tmax)
    elif kind == "planes":
        ref = jintersect.intersect_planes(jrays, jscene.planes, EPSILON, tmax)
        out = intersect.intersect_planes(rays, tscene.planes, EPSILON, tmax)
    else:
        cull = kind == "triangles"
        ref = jintersect.intersect_triangles(jrays, jscene.triangles, EPSILON,
                                             tmax, backface_cull=cull)
        out = intersect.intersect_triangles(rays, tscene.triangles, EPSILON,
                                            tmax, backface_cull=cull)
    valid = _assert_hits_equal(ref, out)
    assert 0.02 < valid.mean() < 0.98


def test_hit_none_and_closer():
    none = Hit.none(3)
    assert not none.valid.any() and torch.isinf(none.t).all()
    assert (none.material_id == -1).all() and none.normal.abs().sum() == 0
    _, tscene = _random_scene(0)
    _, rays = _random_rays(0, 3)
    sph = intersect.intersect_spheres(rays, tscene.spheres, EPSILON, INFINITY)
    merged = closer(none, sph)
    assert torch.equal(merged.t, sph.t) and torch.equal(merged.valid, sph.valid)


def test_intersect_scene_regimes():
    """Unfinalized: the plain intersects; finalized: K3's plain version and
    the recompute, which agree; with an LBVH over the triangles, either
    regime with the LBVH walk in the triangles' place, which selects as they
    do."""
    scene, _ = presets.defocus_blur()
    _, rays = _random_rays(3, 1024)
    plain = integrator.intersect_scene(scene, rays, EPSILON)
    fused = integrator.intersect_scene(finalize(scene, use_bvh=False), rays, EPSILON)
    np.testing.assert_array_equal(fused.valid.numpy(), plain.valid.numpy())
    np.testing.assert_array_equal(fused.material_id.numpy(), plain.material_id.numpy())
    np.testing.assert_allclose(fused.t.numpy(), plain.t.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fused.normal.numpy(), plain.normal.numpy(),
                               rtol=1e-4, atol=1e-4)
    _, soup = _random_scene(3)  # spheres, planes and 40 triangles
    plain = integrator.intersect_scene(soup, rays, EPSILON)
    assert plain.valid.float().mean() > 0.2
    lbvh = Scene(**{**soup.__dict__, "bvh": build_bvh(soup.triangles)})
    for regime in (lbvh, Scene(**{**finalize(soup, use_bvh=False).__dict__,
                                  "bvh": lbvh.bvh})):
        hit = integrator.intersect_scene(regime, rays, EPSILON)
        np.testing.assert_array_equal(hit.valid.numpy(), plain.valid.numpy())
        np.testing.assert_array_equal(hit.material_id.numpy(), plain.material_id.numpy())
        np.testing.assert_allclose(hit.t.numpy(), plain.t.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(hit.normal.numpy(), plain.normal.numpy(),
                                   rtol=1e-4, atol=1e-4)
