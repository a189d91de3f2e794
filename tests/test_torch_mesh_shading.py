"""The mesh path's hit recompute (ops/fused.intersect_scene_fused) and BSDF
(ops/materials.scatter) against the JAX reference on the CPU.

Tolerance 1e-5 (relative for t, absolute for unit vectors and weights).
XLA's CPU code contracts a*b + c into fused multiply-adds and takes its
own float32 transcendentals, where the port rounds each operation and takes
sqrt, sin, cos and pow in float64; on a ray whose winner or branch sits on
a threshold (an edge, a Fresnel draw) the two may choose differently, so
at most 0.1% of rays may differ. Each test prints the fraction it sees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops.fused import intersect_scene_fused as jfused
from raytracingthenextweekcuda_tpu.ops.geometry import Materials as JMaterials
from raytracingthenextweekcuda_tpu.ops.materials import scatter as jscatter
from raytracingthenextweekcuda_tpu.ops.rays import Hit as JHit
from raytracingthenextweekcuda_tpu.ops.rays import Rays as JRays
from raytracingthenextweekcuda_tpu_torch.config import EPSILON
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import materials, threefry
from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene, intersect_scene_fused
from raytracingthenextweekcuda_tpu_torch.ops.geometry import Materials
from raytracingthenextweekcuda_tpu_torch.ops.rays import Hit, Rays

MAX_DIFFER = 1e-3
TOL = 1e-5


def _report(name, bad):
    frac = float(np.mean(bad))
    print(f"{name}: {frac:.4%} of {bad.size} rays differ")
    assert frac <= MAX_DIFFER, f"{name}: {frac:.4%} of rays differ"


def _mesh_rays(kind):
    """Primary rays of the mesh_showcase camera, or rays from random points
    around the sphere and floor in random directions."""
    _, camera = tpresets.mesh_showcase(16, 32)
    if kind == "primary":
        words = threefry.split(threefry.key(9), 2)
        rays, _ = tcam.generate_rays_multi(tcam.derive(camera, 1.0), words, 48, 48)
        return rays.origin.numpy(), rays.direction.numpy(), rays.time.numpy()
    g = np.random.default_rng(4)
    n = 4608
    o = g.uniform((-1.0, -0.5, -1.0), (1.0, 1.2, 0.5), (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, g.random(n).astype(np.float32)


@pytest.mark.parametrize("kind", ["primary", "scattered"])
def test_intersect_scene_fused_matches_reference(kind, monkeypatch):
    monkeypatch.setenv("RTNW_BVH_CACHE", "")
    jscene = jfinalize(jpresets.mesh_showcase(16, 32)[0])
    tscene = finalize(tpresets.mesh_showcase(16, 32)[0])
    o, d, tm = _mesh_rays(kind)
    alive = np.random.default_rng(5).random(o.shape[0]) > 0.1
    ref = jfused(jscene, jscene.packed, JRays(jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(tm)),
                 EPSILON, interpret=True, alive=jnp.asarray(alive))
    out = intersect_scene_fused(device_scene(tscene, "cpu"),
                                Rays(*(torch.from_numpy(x) for x in (o, d, tm))),
                                EPSILON, alive=torch.from_numpy(alive))
    # Live rays only: the reference's analytic kernel also selects for dead
    # rays of live blocks, and every consumer masks them by `alive`.
    valid = np.asarray(ref.valid)
    assert valid[alive].mean() > 0.2 and not out.valid.numpy()[~alive].any()
    same = (valid == out.valid.numpy()) & (
        np.asarray(ref.material_id) == out.material_id.numpy())
    t_ok = np.isclose(out.t.numpy(), np.asarray(ref.t), rtol=TOL, atol=0.0)
    n_ok = np.isclose(out.normal.numpy(), np.asarray(ref.normal),
                      rtol=0.0, atol=TOL).all(axis=1)
    f_ok = out.front_face.numpy() == np.asarray(ref.front_face)
    _report(f"intersect_scene_fused {kind}",
            ~(same & np.where(valid, t_ok & n_ok & f_ok, True))[alive])
    assert (out.material_id.numpy()[valid & alive] == 1).any()  # the mesh is hit


def test_scatter_matches_reference_all_kinds():
    g = np.random.default_rng(7)
    n = 8192
    kinds = np.arange(8, dtype=np.int32)
    albedo = g.uniform(0.1, 1.0, (8, 3)).astype(np.float32)
    param = np.asarray([0.0, 0.3, 1.5, 4.0, 20.0, 0.0, 0.0, 1.33], np.float32)
    emission = np.zeros((8, 3), np.float32)
    emission[3] = (1.0, 0.5, 0.25)
    mid = g.integers(0, 8, n).astype(np.int32)
    normal = g.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    direction = g.normal(size=(n, 3)).astype(np.float32)
    front = g.random(n) > 0.3
    # Face the normal against the ray, as the hit record does.
    flip = (direction * normal).sum(axis=1) > 0
    normal[flip] = -normal[flip]
    origin = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    # Uniforms on pcg4d's 2^-24 grid, as the renderer draws them.
    u4 = (g.integers(0, 1 << 24, (n, 4)) * np.float32(2.0 ** -24)).astype(np.float32)
    t = g.uniform(0.1, 2.0, n).astype(np.float32)

    jmat = JMaterials(jnp.asarray(kinds), jnp.asarray(albedo), jnp.asarray(param),
                      jnp.asarray(emission)).gather(jnp.asarray(mid))
    ref = jscatter(jnp.asarray(u4),
                   JRays(jnp.asarray(origin), jnp.asarray(direction),
                         jnp.zeros(n, jnp.float32)),
                   JHit(jnp.asarray(t), jnp.asarray(normal), jnp.asarray(front),
                        jnp.asarray(mid), jnp.ones(n, bool)),
                   jmat, used_kinds=None)
    table = materials.material_table(Materials(kinds, albedo, param, emission), "cpu")
    mat = materials.gather(table, torch.from_numpy(mid).long())
    out = materials.scatter(
        torch.from_numpy(u4),
        Rays(torch.from_numpy(origin), torch.from_numpy(direction), torch.zeros(n)),
        Hit(torch.from_numpy(t), torch.from_numpy(normal), torch.from_numpy(front),
            torch.from_numpy(mid).long(), torch.ones(n, dtype=torch.bool)),
        mat, used_kinds=None)
    ok = np.ones(n, bool)
    for field in ("direction", "attenuation", "emitted"):
        ok &= np.isclose(getattr(out, field).numpy(), np.asarray(getattr(ref, field)),
                         rtol=0.0, atol=TOL).all(axis=1)
    ok &= out.scattered.numpy() == np.asarray(ref.scattered)
    for k in kinds:
        sel = mid == k
        _report(f"scatter kind {k}", ~ok[sel])
    # A used-kinds subset evaluates only those branches, as the reference.
    sub = materials.scatter(torch.from_numpy(u4), Rays(
        torch.from_numpy(origin), torch.from_numpy(direction), torch.zeros(n)),
        Hit(torch.from_numpy(t), torch.from_numpy(normal), torch.from_numpy(front),
            torch.from_numpy(mid).long(), torch.ones(n, dtype=torch.bool)),
        mat, used_kinds=(0, 3, 6))
    sel = np.isin(mid, (0, 3, 6))
    np.testing.assert_array_equal(sub.direction.numpy()[sel],
                                  out.direction.numpy()[sel])


def test_samplers_and_closer_match_reference():
    """The `*_from_uniforms` samplers at 1e-5 and the hit merge bit for
    bit."""
    from raytracingthenextweekcuda_tpu.ops import rays as jrays
    from raytracingthenextweekcuda_tpu.ops import sampling as jsampling
    from raytracingthenextweekcuda_tpu_torch.ops import rays as trays
    from raytracingthenextweekcuda_tpu_torch.ops import sampling

    g = np.random.default_rng(8)
    n = 4096
    axis = g.normal(size=(n, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    u1, u2 = (g.random(n).astype(np.float32) for _ in range(2))
    expo = g.uniform(0.0, 50.0, n).astype(np.float32)
    pairs = [
        (jsampling.cosine_hemisphere_from_uniforms(u1, u2, jnp.asarray(axis)),
         sampling.cosine_hemisphere_from_uniforms(
             torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(axis))),
        (jsampling.phong_lobe_from_uniforms(u1, u2, jnp.asarray(axis), expo),
         sampling.phong_lobe_from_uniforms(
             torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(axis),
             torch.from_numpy(expo))),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0.0, atol=TOL)

    def hits(seed):
        h = np.random.default_rng(seed)
        return (h.uniform(0, 5, n).astype(np.float32),
                h.normal(size=(n, 3)).astype(np.float32), h.random(n) > 0.5,
                h.integers(-1, 6, n).astype(np.int32), h.random(n) > 0.3)

    a, b = hits(1), hits(2)
    ref = jrays.closer(jrays.Hit(*(jnp.asarray(x) for x in a)),
                       jrays.Hit(*(jnp.asarray(x) for x in b)))
    out = trays.closer(trays.Hit(*(torch.from_numpy(x) for x in a)),
                       trays.Hit(*(torch.from_numpy(x) for x in b)))
    for f in ("t", "normal", "front_face", "material_id", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(out, f).numpy(), err_msg=f)
