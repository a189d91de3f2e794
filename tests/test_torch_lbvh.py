"""The LBVH engine of the port (ops/bvh.py, ops/traverse.py, the LBVH half of
native.py and io/bvh_cache.py, and the integrator's LBVH regime) against
brute force and against the JAX reference on the same numpy inputs.

The mirrors of tests/test_bvh.py and tests/test_native.py: the tree's
invariants, its topology and boxes equal to the reference's build, the
walk's selections equal to the brute intersects (one- and two-sided, a
soup and a mesh) and to the reference's walk, refit equal to a rebuild and
to the reference's refit, the vertex gradient against `jax.grad` and a
finite difference, and the SAH tree of the native builder walked by
`traverse`. Then scenes that carry an LBVH (`scene.bvh`), unfinalized and
finalized, rendered and differentiated against the reference at rtol =
atol = 1e-4 (gradients at rtol 1e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracingthenextweekcuda_tpu import native as jnative
from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.io.procedural import uv_sphere_mesh as juv_sphere
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models.camera import Camera as JCamera
from raytracingthenextweekcuda_tpu.models.scene import SceneBuilder as JBuilder
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops import bvh as jbvh
from raytracingthenextweekcuda_tpu.ops import traverse as jtraverse
from raytracingthenextweekcuda_tpu.ops.geometry import Triangles as JTriangles
from raytracingthenextweekcuda_tpu.ops.rays import Rays as JRays
from raytracingthenextweekcuda_tpu_torch import native
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.io import bvh_cache
from raytracingthenextweekcuda_tpu_torch.io.procedural import uv_sphere_mesh
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    SceneBuilder,
    finalize,
    with_leaves,
)
from raytracingthenextweekcuda_tpu_torch.ops import intersect, threefry, traverse
from raytracingthenextweekcuda_tpu_torch.ops.bvh import BVH, build_bvh, refit
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.geometry import Triangles
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays

INF = float("inf")
TOL = dict(rtol=1e-4, atol=1e-4)


def soup(n, seed=0, spread=2.0, size=0.3):
    """tests/test_bvh.py's random soup, as numpy (vertices, material ids)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 1, 3)).astype(np.float32)
    verts = base + rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    return verts, rng.integers(0, 4, n).astype(np.int32)


def random_rays(n, seed=1, spread=4.0):
    """tests/test_bvh.py's rays from a shell aimed near the origin, as
    numpy (origin, direction)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target = rng.uniform(-spread / 3, spread / 3, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def both_triangles(verts, mat):
    zeros = np.zeros(len(verts), np.int32)
    return (Triangles(verts, mat, zeros),
            JTriangles(jnp.asarray(verts), jnp.asarray(mat), jnp.asarray(zeros)))


def both_rays(o, d):
    n = len(o)
    return (Rays(torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n)),
            JRays(jnp.asarray(o), jnp.asarray(d), jnp.zeros((n,), jnp.float32)))


def test_tree_invariants_and_reference_build():
    verts, mat = soup(257)
    tris, jtris = both_triangles(verts, mat)
    bvh = build_bvh(tris)
    T, I = 257, 256
    assert bvh.num_internal == I and bvh.num_leaves == T
    left, right = bvh.left.numpy(), bvh.right.numpy()
    first, last = bvh.range_first.numpy(), bvh.range_last.numpy()
    assert first[0] == 0 and last[0] == T - 1
    children = np.concatenate([left, right])
    assert len(np.unique(children)) == len(children) == 2 * I and 0 not in children
    lo, hi = bvh.node_lo.numpy(), bvh.node_hi.numpy()
    v = verts[bvh.tri_order.numpy()]
    np.testing.assert_array_equal(lo[I:], v.min(axis=1))
    np.testing.assert_array_equal(hi[I:], v.max(axis=1))
    for child in (left, right):
        assert (lo[:I] <= lo[child]).all() and (hi[:I] >= hi[child]).all()
    for node in [0, 1, I // 2, I - 1]:
        lf = first[left[node]] if left[node] < I else left[node] - I
        ll = last[left[node]] if left[node] < I else left[node] - I
        rf = first[right[node]] if right[node] < I else right[node] - I
        rl = last[right[node]] if right[node] < I else right[node] - I
        assert lf == first[node] and rl == last[node] and ll + 1 == rf
    # The same tree as the reference's, bit for bit.
    for name, a, b in zip(BVH._fields, bvh, jbvh.build_bvh(jtris)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _compare(verts, mat, o, d, backface_cull=True, bvh=None, jbvh_=None):
    """The LBVH walk against the brute intersects and the reference's walk."""
    tris, jtris = both_triangles(verts, mat)
    rays, jrays = both_rays(o, d)
    bvh = build_bvh(tris) if bvh is None else bvh
    jbvh_ = jbvh.build_bvh(jtris) if jbvh_ is None else jbvh_
    brute = intersect.intersect_triangles(rays, tris, 1e-3, INF, backface_cull)
    accel = traverse.intersect_bvh(rays, tris, bvh, 1e-3, INF, backface_cull)
    ref = jtraverse.intersect_bvh(jrays, jtris, jbvh_, 1e-3, INF, backface_cull)
    valid = brute.valid.numpy()
    assert valid.mean() > 0.05
    np.testing.assert_array_equal(accel.valid.numpy(), valid)
    np.testing.assert_array_equal(accel.material_id.numpy(),
                                  brute.material_id.numpy())
    np.testing.assert_allclose(accel.t.numpy()[valid], brute.t.numpy()[valid],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(accel.normal.numpy()[valid],
                               brute.normal.numpy()[valid], atol=1e-5)
    # The reference's walk selects the same triangles.
    np.testing.assert_array_equal(accel.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(accel.material_id.numpy(),
                                  np.asarray(ref.material_id))
    np.testing.assert_allclose(accel.t.numpy()[valid], np.asarray(ref.t)[valid],
                               **TOL)
    _, tri, _, _ = traverse.traverse(rays, tris, bvh, 1e-3, INF, backface_cull)
    _, jtri, _, _ = jtraverse.traverse(jrays, jtris, jbvh_, 1e-3, INF,
                                       backface_cull)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))


@pytest.mark.parametrize("case", ["soup", "two_sided", "mesh"])
def test_bvh_matches_brute_force_and_reference(case):
    if case == "soup":
        _compare(*soup(313, seed=3), *random_rays(512, seed=4))
    elif case == "two_sided":
        _compare(*soup(128, seed=5), *random_rays(256, seed=6), backface_cull=False)
    else:
        mesh = uv_sphere_mesh(0.8, n_lat=12, n_lon=24)
        np.testing.assert_array_equal(mesh, juv_sphere(0.8, n_lat=12, n_lon=24))
        _compare(mesh, np.zeros(len(mesh), np.int32),
                 *random_rays(512, seed=7, spread=2.0))


def test_traverse_skips_dead_rays():
    verts, mat = soup(128, seed=13)
    tris, _ = both_triangles(verts, mat)
    rays, _ = both_rays(*random_rays(256, seed=14))
    bvh = build_bvh(tris)
    alive = torch.arange(256) % 3 != 0
    full = traverse.traverse(rays, tris, bvh, 1e-3, INF)
    part = traverse.traverse(rays, tris, bvh, 1e-3, INF, alive=alive)
    assert (part[1][~alive] == -1).all() and (full[1][~alive] >= 0).any()
    for a, b in zip(full, part):
        np.testing.assert_array_equal(a[alive].numpy(), b[alive].numpy())


def test_refit_matches_rebuild_and_reference():
    verts, mat = soup(100, seed=8)
    tris, jtris = both_triangles(verts, mat)
    bvh = build_bvh(tris)
    moved = Triangles(torch.from_numpy(verts + 0.5), mat, tris.mesh_id)
    refitted = refit(bvh, moved)
    rebuilt = build_bvh(Triangles(verts + 0.5, mat, tris.mesh_id))
    np.testing.assert_array_equal(refitted.left.numpy(), bvh.left.numpy())
    np.testing.assert_allclose(refitted.node_lo.numpy(), rebuilt.node_lo.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(refitted.node_hi.numpy(), rebuilt.node_hi.numpy(),
                               atol=1e-5)
    ref = jbvh.refit(jbvh.build_bvh(jtris),
                     jtris._replace(vertices=jtris.vertices + 0.5))
    np.testing.assert_array_equal(refitted.node_lo.numpy(), np.asarray(ref.node_lo))
    np.testing.assert_array_equal(refitted.node_hi.numpy(), np.asarray(ref.node_hi))


def test_vertex_gradient_through_bvh_hit():
    verts, mat = soup(128, seed=10, size=0.8)
    tris, jtris = both_triangles(verts, mat)
    o, d = random_rays(256, seed=11)
    rays, jrays = both_rays(o, d)
    bvh, jtree = build_bvh(tris), jbvh.build_bvh(jtris)
    target = int(np.flatnonzero(
        traverse.intersect_bvh(rays, tris, bvh, 1e-3, INF).valid.numpy())[0])

    def t_of_shift(dz):
        shift = torch.zeros(3)
        shifted = Triangles(torch.from_numpy(verts) + torch.stack(
            [shift[0], shift[1], dz]), mat, tris.mesh_id)
        return traverse.intersect_bvh(rays, shifted, bvh, 1e-3, INF).t[target]

    def jt_of_shift(dz):
        shifted = jtris._replace(vertices=jtris.vertices.at[:, :, 2].add(dz))
        return jtraverse.intersect_bvh(jrays, shifted, jtree, 1e-3, INF).t[target]

    dz = torch.tensor(0.0, requires_grad=True)
    t_of_shift(dz).backward()
    jgrad = jax.grad(jt_of_shift)(jnp.float32(0.0))
    assert abs(float(dz.grad)) > 1e-3
    np.testing.assert_allclose(float(dz.grad), float(jgrad), rtol=1e-3, atol=1e-6)
    with torch.no_grad():
        fd = (t_of_shift(torch.tensor(1e-3)) - t_of_shift(torch.tensor(-1e-3))) / 2e-3
    np.testing.assert_allclose(float(dz.grad), float(fd), rtol=2e-2, atol=1e-3)


def test_cache_roundtrip(tmp_path):
    verts, mat = soup(50, seed=12)
    tris, _ = both_triangles(verts, mat)
    bvh = build_bvh(tris)
    p = str(tmp_path / "m.bvh.npz")
    bvh_cache.save_bvh(p, bvh)
    for a, b in zip(bvh, bvh_cache.load_bvh(p)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    mesh_path = str(tmp_path / "mesh.obj")
    b1 = bvh_cache.build_or_load(tris, mesh_path)
    path = bvh_cache.cache_path_for(mesh_path, verts)
    assert path.startswith(mesh_path) and (tmp_path / path.split("/")[-1]).exists()
    b2 = bvh_cache.build_or_load(tris, mesh_path)  # a cache hit
    np.testing.assert_array_equal(b1.left.numpy(), b2.left.numpy())
    assert bvh_cache.build_or_load(tris).left.shape == (49,)  # no path: no cache


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_sah_tree_walked_by_traverse():
    """tests/test_native.py:37: the native SAH tree, as a BVH, walked by
    traverse equals brute force and the reference's walk of its SAH tree."""
    verts, mat = soup(257, seed=21)
    bvh = native.build_sah_bvh(verts).to_bvh()
    assert sorted(bvh.tri_order.tolist()) == list(range(257))
    _, jtris = both_triangles(verts, mat)
    _compare(verts, mat, *random_rays(512, seed=22), bvh=bvh,
             jbvh_=jnative.build_sah_bvh(jtris))


# --------------------------------------------------------------------------
# Scenes with an LBVH
# --------------------------------------------------------------------------

CAMERA = dict(eye=(0, 0.4, 2.6), center=(0, 0, 0), fov=45.0, aperture=0.0,
              focus_distance=2.6, time1=1.0)


def _build(builder, sphere_mesh):
    """A plane, a light and a 12x24 UV sphere (528 triangles), the first
    of two materials lambertian and the mesh's metal."""
    b = builder()
    b.lambertian(0, (0.73, 0.73, 0.73))
    b.metal(1, (0.9, 0.6, 0.2), 0.1)
    b.emission(2, (1.0, 1.0, 1.0), 4.0)
    b.plane((0, -1.05, 0), (0, 1, 0), (5, 0, 5), 2, 0)
    b.sphere((0, 4, 0), 2.0, 2)
    b.mesh(sphere_mesh(0.9, (0, 0, 0), 12, 24), 1)
    return b.build()


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "k3"])
def lbvh_scenes(request):
    """(reference scene, port scene, camera) with an LBVH over the mesh;
    `k3` finalizes both first (a brute-force pack, 528 triangles), so the
    pack covers the spheres, planes and triangles and the LBVH adds its
    walk, as in the reference."""
    jscene, tscene = _build(JBuilder, juv_sphere), _build(SceneBuilder, uv_sphere_mesh)
    if request.param:
        jscene, tscene = jfinalize(jscene, use_bvh=False), finalize(tscene,
                                                                    use_bvh=False)
    jscene = jscene._replace(bvh=jbvh.build_bvh(jscene.triangles))
    tscene = dataclasses.replace(tscene, bvh=build_bvh(tscene.triangles))
    return jscene, tscene, Camera.make(**CAMERA)


@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_lbvh_render_matches_reference(lbvh_scenes, rr):
    jscene, tscene, camera = lbvh_scenes
    kw = dict(width=16, height=12, spp=2, bounces=4, spp_per_pass=2,
              russian_roulette=rr, rr_start_bounce=1)
    ref = jintegrator.render(jscene, JCamera.make(**CAMERA), JConfig(**kw))
    launches = (bk.KERNEL_LAUNCHES, bk.PATH_LAUNCHES)
    steps = traverse.STEPS
    film = integrator.render(tscene, camera, RenderConfig(**kw), device="cpu")
    assert traverse.STEPS > steps and (bk.KERNEL_LAUNCHES, bk.PATH_LAUNCHES) == launches
    out = film.accum.numpy()
    assert np.isfinite(out).all() and out.mean() > 0.01
    np.testing.assert_allclose(out, np.asarray(ref.accum), **TOL)


def test_lbvh_gbuffer_matches_reference(lbvh_scenes):
    jscene, tscene, camera = lbvh_scenes
    kw = dict(width=16, height=12, spp=2, bounces=3)
    ref = jintegrator.render_gbuffer(jscene, JCamera.make(**CAMERA),
                                     jax.random.key(4), JConfig(**kw), 2)
    out = integrator.render_gbuffer(tscene, camera, threefry.key(4),
                                    RenderConfig(**kw), 2, device="cpu")
    assert 0.05 < float(out["hit_mask"].mean()) < 1.0
    for name in out:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, **TOL)


def test_lbvh_equals_brute_force_scene(lbvh_scenes):
    """The same scene without its LBVH (brute-force triangles) renders the
    same image: the LBVH only selects."""
    _, tscene, camera = lbvh_scenes
    cfg = RenderConfig(width=16, height=12, spp=2, bounces=4, spp_per_pass=2,
                       fused_bounce=False)
    a = integrator.render(tscene, camera, cfg, device="cpu").accum.numpy()
    b = integrator.render(dataclasses.replace(tscene, bvh=None), camera, cfg,
                          device="cpu").accum.numpy()
    np.testing.assert_allclose(a, b, **TOL)


def test_lbvh_depth_gradient_matches_jax(lbvh_scenes):
    """d mean(depth) / d (a z shift of every vertex) through the LBVH walk,
    the LBVH built before the shift, against jax.grad."""
    jscene, tscene, camera = lbvh_scenes
    kw = dict(width=12, height=10, spp=1, bounces=2)
    verts = np.asarray(tscene.triangles.vertices, np.float32)

    def jloss(dz):
        tri = jscene.triangles._replace(
            vertices=jscene.triangles.vertices.at[:, :, 2].add(dz))
        g = jintegrator.render_gbuffer(jscene._replace(triangles=tri),
                                       JCamera.make(**CAMERA), jax.random.key(2),
                                       JConfig(**kw), 1)
        return jnp.mean(g["depth"])

    jval, jgrad = jax.value_and_grad(jloss)(jnp.float32(0.0))
    dz = torch.tensor(0.0, requires_grad=True)
    shift = torch.zeros(3)
    v = torch.from_numpy(verts) + torch.stack([shift[0], shift[1], dz])
    g = integrator.render_gbuffer(with_leaves(tscene, {"triangles.vertices": v}),
                                  camera, threefry.key(2), RenderConfig(**kw), 1,
                                  device="cpu")
    loss = g["depth"].mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), **TOL)
    assert abs(float(dz.grad)) > 1e-4
    np.testing.assert_allclose(float(dz.grad), float(jgrad), rtol=1e-3, atol=1e-6)
