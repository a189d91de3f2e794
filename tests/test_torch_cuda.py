"""K1, K2, K0, K3 and K4 against their plain versions on a CUDA card (K1,
K2 and K0 at rtol = atol = 1e-4, also on tile-BVH packs; K1 bit for bit
where path lengths are most uneven; K1, K2 and K0 with the tile-BVH walk bit
for bit on warps that walk with part of their lanes and on ties between
leaves; K2 bit for bit on its persistent grid below and above one
resident grid, K0 from below a warp to above a resident grid; K3 and K4
bit for bit, K4 also for every count of rays that need a leaf, on ties
and on skipped prefetches, and K4's stats counters equal to the plain
version's), renders (and one backward of the differentiable wavefront and
of the LBVH regime, and a scene file through `render --scene`) on the card
against the same on the CPU, and tile-sharded passes on the card against
render_pass there. These tests skip without a card. The file imports no
jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays
from test_torch_walk import inside_rays, tie_inputs

PRESETS = ["diffuse_sphere_plane", "cornell_box", "defocus_blur",
           "smallpt_spheres", "mesh_showcase"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
def test_k1_matches_plain_on_card(preset, cuda_device):
    scene, camera = getattr(tpresets, preset)()
    scene = finalize(scene, use_bvh=False)
    cfg = RenderConfig(width=64, height=64, spp=4, bounces=6, spp_per_pass=4)
    inp = bk.render_inputs(scene.packed, tcam.derive(camera, 1.0),
                           threefry.split(threefry.key(7), 4), cfg,
                           device=cuda_device)
    before = bk.KERNEL_LAUNCHES
    k1 = bk.render_kernel(inp).cpu().numpy()
    plain = bk.render_reference(inp).cpu().numpy()
    assert bk.KERNEL_LAUNCHES == before + 1
    if preset == "smallpt_spheres":
        assert (np.abs(k1 - plain) > 0.2).mean() < 0.05
    else:
        np.testing.assert_allclose(k1, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=24, height=16, spp=4, bounces=6, spp_per_pass=2,
                       russian_roulette=True, rr_start_bounce=2)
    before = bk.KERNEL_LAUNCHES
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert bk.KERNEL_LAUNCHES == before + 2  # one launch per pass
    cpu = integrator.render(scene, camera, cfg, device="cpu")
    np.testing.assert_allclose(card.accum.cpu().numpy(), cpu.accum.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mesh_scene():
    scene, camera = tpresets.mesh_showcase(16, 32)
    return finalize(scene), camera


def _mesh_wavefront(scene, camera, device, bounces):
    """A 64x64, 2-spp wavefront of the tile-BVH mesh after `bounces`
    bounces of the sorted engine, on `device`: (DeviceScene, rays, alive)."""
    from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene
    from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table

    cfg = RenderConfig(width=64, height=64, spp=2, bounces=4)
    words = threefry.split(threefry.key(11), 2)
    ds = device_scene(scene, device)
    rays, ctx = tcam.generate_rays_multi(tcam.derive(camera, 1.0), words, 64, 64,
                                         device)
    n = rays.count
    state = (rays, torch.ones((n, 3), device=device),
             torch.zeros((n, 3), device=device),
             torch.ones((n,), dtype=torch.bool, device=device))
    mats = material_table(scene.materials, device)
    for b in range(bounces):
        state = integrator._bounce_body(ds, mats, scene.packed.used_kinds, cfg,
                                        state, ctx, b)
    return ds, state[0], state[3]


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [0, 2])
def test_k3_k4_match_plain_on_card(cuda_device, bounces, mesh_scene):
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
    from raytracingthenextweekcuda_tpu_torch.ops.fused import mesh_query

    ds, rays, alive = _mesh_wavefront(*mesh_scene, cuda_device, bounces)
    before = (k3.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES)
    t, code = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
    t_p, code_p = k3.closest_hit_reference(rays.origin, rays.direction,
                                           rays.time, alive, ds.analytic, EPSILON)
    assert torch.equal(code, code_p) and torch.equal(t, t_p)
    alive_mesh, t_cap = mesh_query(ds.leaves, rays, EPSILON, alive, t, code)
    args = k4.winner_inputs(rays, ds.leaves, EPSILON, alive_mesh, t_cap)
    t4, c4 = k4.winner(*args, ds.leaves, EPSILON)
    t4p, c4p = k4.winner_reference(*args, ds.leaves, EPSILON)
    assert torch.equal(c4, c4p) and torch.equal(t4, t4p)
    assert int((c4 >= 0).sum()) > 0
    assert (k3.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_mesh_render_on_card_matches_cpu(cuda_device, mesh_scene):
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3

    scene, camera = mesh_scene
    cfg = RenderConfig(width=24, height=16, spp=4, bounces=5, spp_per_pass=2,
                       russian_roulette=True, rr_start_bounce=2)
    before = (k3.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES)
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert k3.KERNEL_LAUNCHES > before[0] and k4.KERNEL_LAUNCHES > before[1]
    cpu = integrator.render(scene, camera, cfg, device="cpu")
    np.testing.assert_allclose(card.accum.cpu().numpy(), cpu.accum.numpy(),
                               rtol=1e-4, atol=1e-4)


def _primary(preset, size, device, seed=7):
    """A finalized preset's primary wavefront of one sample on `device`:
    (scene, rays, ctx)."""
    scene, camera = getattr(tpresets, preset)()
    scene = finalize(scene, use_bvh=False)
    rays, ctx = tcam.generate_rays(tcam.derive(camera, 1.0),
                                   threefry.split(threefry.key(seed), 1)[0],
                                   size, size, device=device)
    return scene, rays, ctx


@pytest.mark.cuda
@pytest.mark.parametrize("preset", PRESETS)
def test_k2_matches_plain_on_card(preset, cuda_device):
    scene, rays, ctx = _primary(preset, 64, cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=1, bounces=8)
    before = bk.PATH_LAUNCHES
    k2 = bk.path_trace(scene.packed, rays, ctx, cfg).cpu().numpy()
    plain = bk.path_trace_reference(scene.packed, rays, ctx, cfg).cpu().numpy()
    assert bk.PATH_LAUNCHES == before + 1
    if preset == "smallpt_spheres":
        assert (np.abs(k2 - plain) > 0.2).mean() < 0.05
    else:
        np.testing.assert_allclose(k2, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("do_rr", [0, 1])
def test_k0_matches_plain_on_card(do_rr, cuda_device):
    from raytracingthenextweekcuda_tpu_torch.ops import rng

    scene, rays, ctx = _primary("cornell_box", 64, cuda_device)
    cfg = RenderConfig(width=64, height=64, spp=1, bounces=4,
                       russian_roulette=True, rr_start_bounce=0)
    state = bk.planar_state(rays)
    state = bk.bounce_step_reference(
        scene.packed, state, rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0),
        0, cfg)
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 1)
    before = bk.BOUNCE_LAUNCHES
    k0 = bk.bounce_step(scene.packed, state, u4, do_rr, cfg)
    plain = bk.bounce_step_reference(scene.packed, state, u4, do_rr, cfg)
    assert bk.BOUNCE_LAUNCHES == before + 1
    assert torch.equal(k0[7], plain[7])
    for k in range(14):
        np.testing.assert_allclose(k0[k].cpu().numpy(), plain[k].cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f"row {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("do_rr", [0, 1])
@pytest.mark.parametrize("size", ["below_a_warp", "not_a_multiple",
                                  "above_the_grid", "full"])
def test_k0_matches_plain_on_card_by_size(size, do_rr, cuda_device):
    """K0 without the walk, its carry as row pointers: 17 rays (below one
    warp), 4,001 (not a multiple of 32), one ray more than a resident grid
    holds (a second wave of one ray) and 512x512 (about two waves); about a
    quarter of the rays dead, with and without Russian roulette. Every row
    bit for bit against the plain version, the dead rays passed through."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    scene, rays, ctx = _primary("cornell_box", 512, cuda_device)
    cfg = RenderConfig(width=512, height=512, spp=1, bounces=4,
                       russian_roulette=True, rr_start_bounce=0)
    ctas, threads = build.occupancy("rtnw_render_occupancy", 2, 0,
                                    *bk.scene_inputs(scene.packed, cfg).counts)
    resident = ctas * threads * torch.cuda.get_device_properties(0).multi_processor_count
    n = {"below_a_warp": 17, "not_a_multiple": 4001, "above_the_grid": resident + 1,
         "full": rays.count}[size]
    assert n <= rays.count
    rays, ctx = _head(rays, ctx, n)
    state = bk.bounce_step_reference(
        scene.packed, bk.planar_state(rays),
        rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0), 0, cfg)
    gen = np.random.default_rng(n)
    kill = torch.from_numpy(gen.random(n) < 0.25).to(cuda_device)
    state = (*state[:7], torch.where(kill, 0, state[7]), *state[8:])
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 1)
    before = bk.BOUNCE_LAUNCHES
    k0 = bk.bounce_step(scene.packed, state, u4, do_rr, cfg)
    plain = bk.bounce_step_reference(scene.packed, state, u4, do_rr, cfg)
    assert bk.BOUNCE_LAUNCHES == before + 1
    for k in range(14):
        assert torch.equal(k0[k], plain[k]), f"row {k}"
    dead = state[7] == 0
    assert bool(dead.any()) and not bool(k0[7][dead].any())
    for k in (0, 3, 11):
        assert torch.equal(k0[k][dead], state[k][dead])


@pytest.mark.cuda
def test_wavefront_backward_on_card_matches_cpu(cuda_device):
    """fused_bounce=False on the card: K3 selects, the torch recompute and
    BSDF differentiate; the G-buffer and its depth gradient equal the CPU's."""
    from raytracingthenextweekcuda_tpu_torch.models.scene import with_leaves

    scene, camera = tpresets.diffuse_sphere_plane()
    scene = finalize(scene)
    cfg = RenderConfig(width=24, height=24, spp=2, bounces=4, fused_bounce=False)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        c = torch.tensor(np.asarray(scene.spheres.center0), device=dev,
                         requires_grad=True)
        live = with_leaves(scene, {"spheres.center0": c, "spheres.center1": c})
        g = integrator.render_gbuffer(live, camera, threefry.key(1), cfg, 2,
                                      device=dev)
        (g["depth"].mean() + g["radiance"].mean()).backward()
        out[dev.type] = (g["radiance"].detach().cpu().numpy(),
                         g["depth"].detach().cpu().numpy(), c.grad.cpu().numpy())
    for card, cpu in zip(out["cuda"], out["cpu"]):
        assert np.isfinite(card).all()
        np.testing.assert_allclose(card, cpu, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("stand_in", ["published", "stress"])
def test_bvh_kernels_match_plain_on_card(stand_in, cuda_device):
    """K1, K2 and K0 on a tile-BVH pack (the mesh stand-ins: 2 and 32
    leaves of 768) against their plain versions, which walk it as one
    consensus block."""
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes
    from raytracingthenextweekcuda_tpu_torch.ops import rng

    scene, camera, _ = getattr(bench_scenes, f"{stand_in}_mesh_scene")()
    scene = finalize(scene)
    assert scene.packed.leaf_bounds is not None
    cfg = RenderConfig(width=64, height=64, spp=2, bounces=6, spp_per_pass=2,
                       russian_roulette=True, rr_start_bounce=3)
    frame = tcam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.key(3), 2)
    before = (bk.KERNEL_BVH_LAUNCHES, bk.PATH_BVH_LAUNCHES, bk.BOUNCE_BVH_LAUNCHES)
    inp = bk.render_inputs(scene.packed, frame, words, cfg, device=cuda_device)
    np.testing.assert_allclose(bk.render_kernel(inp).cpu().numpy(),
                               bk.render_reference(inp).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    rays, ctx = tcam.generate_rays(frame, words[0], 64, 64, device=cuda_device)
    np.testing.assert_allclose(bk.path_trace(scene.packed, rays, ctx, cfg).cpu().numpy(),
                               bk.path_trace_reference(scene.packed, rays, ctx,
                                                       cfg).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    state = bk.bounce_step_reference(
        scene.packed, bk.planar_state(rays),
        rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0), 0, cfg)
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 1)
    k0 = bk.bounce_step(scene.packed, state, u4, 1, cfg)
    plain = bk.bounce_step_reference(scene.packed, state, u4, 1, cfg)
    assert torch.equal(k0[7], plain[7]) and bool(state[7].any())
    for k in range(14):
        np.testing.assert_allclose(k0[k].cpu().numpy(), plain[k].cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f"row {k}")
    assert (bk.KERNEL_BVH_LAUNCHES, bk.PATH_BVH_LAUNCHES,
            bk.BOUNCE_BVH_LAUNCHES) == tuple(b + 1 for b in before)


@pytest.mark.cuda
def test_forced_megastep_on_card_matches_cpu(cuda_device, mesh_scene, monkeypatch):
    """The forced megastep route (K1 with its tile-BVH walk) on the card
    against the same route on the CPU."""
    scene, camera = mesh_scene
    monkeypatch.setattr(integrator, "_sorted_eligible", lambda *_: False)
    cfg = RenderConfig(width=24, height=16, spp=4, bounces=5, spp_per_pass=2)
    before = bk.KERNEL_BVH_LAUNCHES
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert bk.KERNEL_BVH_LAUNCHES == before + 2
    cpu = integrator.render(scene, camera, cfg, device="cpu")
    np.testing.assert_allclose(card.accum.cpu().numpy(), cpu.accum.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("finalized", [False, True], ids=["plain", "k3"])
def test_lbvh_render_and_gradient_on_card_match_cpu(cuda_device, finalized):
    """A scene with an LBVH over its mesh (the LBVH walk in torch, beside K3
    when finalized) on the card against the CPU: the render at 1e-4 and the
    gradient of the depth mean with respect to a shift of every vertex at
    rtol 1e-3."""
    import dataclasses

    from raytracingthenextweekcuda_tpu_torch.models.scene import with_leaves
    from raytracingthenextweekcuda_tpu_torch.ops import traverse
    from raytracingthenextweekcuda_tpu_torch.ops.bvh import build_bvh

    scene, camera = tpresets.mesh_showcase(16, 32)
    if finalized:
        scene = finalize(scene, use_bvh=False)
    scene = dataclasses.replace(scene, bvh=build_bvh(scene.triangles))
    cfg = RenderConfig(width=24, height=16, spp=2, bounces=4, spp_per_pass=2)
    steps = traverse.STEPS
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert traverse.STEPS > steps
    cpu = integrator.render(scene, camera, cfg, device="cpu")
    np.testing.assert_allclose(card.accum.cpu().numpy(), cpu.accum.numpy(),
                               rtol=1e-4, atol=1e-4)

    def grad(device):
        dz = torch.zeros((), device=device, requires_grad=True)
        shift = torch.zeros(3, device=device)
        v = (torch.from_numpy(np.asarray(scene.triangles.vertices)).to(device)
             + torch.stack([shift[0], shift[1], dz]))
        g = integrator.render_gbuffer(with_leaves(scene, {"triangles.vertices": v}),
                                      camera, threefry.key(2),
                                      RenderConfig(width=24, height=16, spp=1,
                                                   bounces=2), 1, device=device)
        g["depth"].mean().backward()
        return float(dz.grad)

    g_card, g_cpu = grad(cuda_device), grad(torch.device("cpu"))
    assert np.isfinite(g_card) and g_card != 0.0
    np.testing.assert_allclose(g_card, g_cpu, rtol=1e-3, atol=1e-6)


def _grid(nx, ny, z, copies=1):
    """(nx * ny * 2 * copies, 3, 3) triangles of a grid over [-1, 1]^2 at
    height z, facing +z; `copies` stacks exact duplicates of the grid."""
    xs, ys = np.linspace(-1, 1, nx + 1), np.linspace(-1, 1, ny + 1)
    tri = []
    for i in range(nx):
        for j in range(ny):
            a, b = (xs[i], ys[j], z), (xs[i + 1], ys[j], z)
            c, d = (xs[i + 1], ys[j + 1], z), (xs[i], ys[j + 1], z)
            tri += [(a, b, c), (a, c, d)]
    return np.asarray(tri * copies, np.float32)


def _k4_case(tri, o, d, alive, device):
    """K4 and its plain version on the tile-BVH of triangles `tri` for rays
    (o, d) with `alive`, all on `device`: ((t, code), (t, code), args, leaves)."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.models.scene import SceneBuilder
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays

    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.mesh(tri, 0)
    leaves = k4.leaf_scene(finalize(b.build(), use_bvh=True).packed, device)
    rays = Rays(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
                torch.zeros(o.shape[0], device=device))
    args = k4.winner_inputs(rays, leaves, EPSILON, torch.from_numpy(alive).to(device))
    before = k4.KERNEL_LAUNCHES
    out = k4.winner(*args, leaves, EPSILON)
    assert k4.KERNEL_LAUNCHES == before + 1
    return out, k4.winner_reference(*args, leaves, EPSILON), args, leaves


def _down_rays(n, seed, tilt=0.0):
    """Rays from above the grids toward random points of [-0.9, 0.9]^2."""
    g = np.random.default_rng(seed)
    target = np.concatenate([g.uniform(-0.9, 0.9, (n, 2)), np.zeros((n, 1))], 1)
    o = target + np.concatenate([g.uniform(-tilt, tilt, (n, 2)),
                                 np.full((n, 1), 2.0)], 1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 31, 32, 33, 64, 65, 127, 128])
def test_k4_matches_plain_by_needing_rays(m, cuda_device):
    """K4 bit for bit against its plain version on blocks where exactly m
    rays need the one leaf (the rest are dead), at every split of the CTA's
    threads over the listed rays (S = 32 down to 1)."""
    blocks = 8
    o, d = _down_rays(128 * blocks, seed=m)
    g = np.random.default_rng(100 + m)
    alive = np.concatenate([g.permutation(128) < m for _ in range(blocks)])
    (t, c), (tp, cp), _, leaves = _k4_case(_grid(10, 10, 0.0), o, d, alive,
                                           cuda_device)
    assert leaves.n_leaves == 1 and leaves.max_count == 200
    assert torch.equal(c, cp) and torch.equal(t, tp)
    assert int((c >= 0).sum()) > 0.9 * alive.sum()
    assert not (c.cpu().numpy()[~alive] >= 0).any()


@pytest.mark.cuda
def test_k4_ties_match_plain_on_card(cuda_device):
    """Every triangle twice: each hit is a tie at equal t between two
    columns, and K4's reduction keeps the lower one, as the plain scan."""
    o, d = _down_rays(128 * 16, seed=3, tilt=0.3)
    alive = np.ones(o.shape[0], bool)
    (t, c), (tp, cp), _, leaves = _k4_case(_grid(10, 10, 0.0, copies=2), o, d,
                                           alive, cuda_device)
    assert torch.equal(c, cp) and torch.equal(t, tp)
    assert leaves.max_count == 400
    assert int((c >= 0).sum()) > 0.9 * o.shape[0]


@pytest.mark.cuda
def test_k4_skipped_prefetch_matches_plain_on_card(cuda_device):
    """Six stacked grids in several leaves: a block's list holds the leaves
    of every layer below its rays, but after the top layer the re-check
    skips them, so the leaf prefetched behind a scanned one is dropped mid
    list. K4 still equals its plain version bit for bit."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work

    tri = np.concatenate([_grid(40, 10, -0.25 * k) for k in range(6)])
    o, d = _down_rays(128 * 32, seed=5, tilt=0.5)
    alive = np.ones(o.shape[0], bool)
    work.reset()
    (t, c), (tp, cp), args, leaves = _k4_case(tri, o, d, alive, cuda_device)
    assert leaves.n_leaves >= 3
    assert torch.equal(c, cp) and torch.equal(t, tp)
    walked = work.WORK["box_tests"] // 128  # every ray of every block is live
    assert work.WORK["block_leaves"] < walked
    assert float(args[4].counts.float().mean()) >= 3


@pytest.mark.cuda
def test_k4_stats_match_plain_on_card(cuda_device):
    """K4's stats instantiation on the stacked grids: (t, code) as the
    production one's, and each block's [walked, evaluated] as the plain
    version's, with leaves skipped after the top layer (evaluated <
    walked)."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    tri = np.concatenate([_grid(40, 10, -0.25 * k) for k in range(6)])
    o, d = _down_rays(128 * 32, seed=5, tilt=0.5)
    alive = np.random.default_rng(6).random(o.shape[0]) > 0.2
    (t, c), _, args, leaves = _k4_case(tri, o, d, alive, cuda_device)
    before = (k4.KERNEL_LAUNCHES, k4.STATS_LAUNCHES)
    t_s, c_s, st = k4.winner(*args, leaves, EPSILON, stats=True)
    assert (k4.KERNEL_LAUNCHES, k4.STATS_LAUNCHES) == (before[0], before[1] + 1)
    _, _, st_p = k4.winner_reference(*args, leaves, EPSILON, stats=True)
    assert torch.equal(t_s, t) and torch.equal(c_s, c)
    assert st.dtype == torch.int32 and st.shape == (args[4].counts.shape[0], 2)
    assert torch.equal(st.cpu(), st_p.cpu())
    assert (st[:, 1] < st[:, 0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("use_bvh", [False, True], ids=["boxes", "walk"])
def test_k1_uneven_paths_match_plain_on_card(use_bvh, cuda_device):
    """K1 with path regeneration against its plain version where path
    lengths are most uneven (Cornell, Russian roulette from bounce 2, the
    sky off), without and with the tile-BVH walk: equal bit for bit."""
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene, use_bvh=use_bvh)
    cfg = RenderConfig(width=64, height=64, spp=4, bounces=10, spp_per_pass=4,
                       russian_roulette=True, rr_start_bounce=2,
                       sky_background=False)
    inp = bk.render_inputs(scene.packed, tcam.derive(camera, 1.0),
                           threefry.split(threefry.key(9), 4), cfg,
                           device=cuda_device)
    assert (inp.trih is not None) == use_bvh
    before = bk.KERNEL_BVH_LAUNCHES
    k1 = bk.render_kernel(inp).cpu().numpy()
    assert bk.KERNEL_BVH_LAUNCHES == before + use_bvh
    np.testing.assert_array_equal(k1, bk.render_reference(inp).cpu().numpy())


def _head(rays, ctx, n):
    """The first n rays of a wavefront and their context."""
    return (Rays(rays.origin[:n], rays.direction[:n], rays.time[:n]),
            rng.RayCtx(ctx.pixel_id[:n], ctx.base0, ctx.base1))


@pytest.mark.cuda
@pytest.mark.parametrize("stand_in", ["published", "stress"])
def test_walk_on_partial_warps_matches_plain(stand_in, cuda_device):
    """K1, K2 and K0 with the tile-BVH walk where warps walk with part of
    their lanes, bit for bit against their plain versions: K1 over 1,000
    scattered pixels (not a multiple of 32) at 3 spp with Russian roulette,
    so lanes end their samples at different steps; K2 on 4,001 rays; K0 on
    4,001 rays, a third of them dead."""
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes

    scene, camera, _ = getattr(bench_scenes, f"{stand_in}_mesh_scene")()
    scene = finalize(scene)
    cfg = RenderConfig(width=64, height=64, spp=3, bounces=6, spp_per_pass=3,
                       russian_roulette=True, rr_start_bounce=1)
    frame = tcam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.key(5), 3)
    gen = np.random.default_rng(2)
    pid = gen.choice(64 * 64, 1000, replace=False)
    before = (bk.KERNEL_BVH_LAUNCHES, bk.PATH_BVH_LAUNCHES, bk.BOUNCE_BVH_LAUNCHES)
    inp = bk.render_inputs(scene.packed, frame, words, cfg, pixel_ids=pid,
                           device=cuda_device)
    assert torch.equal(bk.render_kernel(inp), bk.render_reference(inp))
    rays, ctx = _head(*tcam.generate_rays(frame, words[0], 64, 64,
                                          device=cuda_device), 4001)
    assert torch.equal(bk.path_trace(scene.packed, rays, ctx, cfg),
                       bk.path_trace_reference(scene.packed, rays, ctx, cfg))
    state = bk.bounce_step_reference(
        scene.packed, bk.planar_state(rays),
        rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0), 0, cfg)
    keep = torch.from_numpy(gen.random(rays.count) > 1 / 3).to(cuda_device)
    state = (*state[:7], state[7] * keep.to(torch.int32), *state[8:])
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 1)
    k0 = bk.bounce_step(scene.packed, state, u4, 1, cfg)
    plain = bk.bounce_step_reference(scene.packed, state, u4, 1, cfg)
    assert bool(state[7].any()) and not bool(state[7].all())
    for k in range(14):
        assert torch.equal(k0[k], plain[k]), f"row {k}"
    assert (bk.KERNEL_BVH_LAUNCHES, bk.PATH_BVH_LAUNCHES,
            bk.BOUNCE_BVH_LAUNCHES) == tuple(b + 1 for b in before)


@pytest.mark.cuda
def test_walk_ties_match_plain_on_card(cuda_device):
    """Triangles copied into a second leaf (tests/test_torch_walk.py): where
    a ray meets one in two leaves at equal t, the warp's split scan keeps
    the lower column as the plain walk does. K2 and K0 on rays from inside
    the sphere aimed at the copies, and K1 from the camera, bit for bit."""
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes

    inp, centroids = tie_inputs(cuda_device)
    n = 4001
    o, d = (torch.from_numpy(x).to(cuda_device) for x in inside_rays(centroids, n, 3))
    gen = np.random.default_rng(6)
    pid = torch.from_numpy(gen.permutation(n).astype(np.int32)).to(cuda_device)
    path = bk.PathInputs(**inp.scene_fields(), origin=o, direction=d,
                         time=torch.zeros(n, device=cuda_device), pid=pid,
                         words=(12345, 678))
    assert torch.equal(bk.path_kernel(path), bk.path_reference(path))
    state = torch.cat([o.t(), d.t(), torch.zeros((1, n), device=cuda_device),
                       torch.ones((3, n), device=cuda_device),
                       torch.zeros((3, n), device=cuda_device)])
    alive = torch.from_numpy((gen.random(n) > 0.2).astype(np.int32)).to(cuda_device)
    step = bk.BounceInputs(**inp.scene_fields(),
                           carry=tuple(row.contiguous() for row in state),
                           alive=alive,
                           u4=torch.from_numpy(gen.random((n, 4), np.float32))
                           .to(cuda_device), do_rr=False)
    (out, live), (out_p, live_p) = bk.bounce_kernel(step), bk.bounce_reference(step)
    assert torch.equal(torch.stack(out), torch.stack(out_p))
    assert torch.equal(live, live_p)
    _, camera, _ = bench_scenes.stress_mesh_scene()
    render = bk.RenderInputs(**inp.scene_fields(), frame=tcam.pack_frame(
        tcam.derive(camera, 1.0), cuda_device),
        words=torch.from_numpy(np.asarray(threefry.split(threefry.key(4), 2),
                                          np.uint32).reshape(-1, 2).view(np.int32)
                               .copy()).to(cuda_device),
        pid=torch.arange(64 * 64, dtype=torch.int32, device=cuda_device),
        width=64, height=64)
    assert torch.equal(bk.render_kernel(render), bk.render_reference(render))


@pytest.mark.cuda
@pytest.mark.parametrize("use_bvh", [False, True], ids=["boxes", "walk"])
@pytest.mark.parametrize("n", [1000, 4001, 512 * 512])
def test_k2_regeneration_matches_plain_on_card(n, use_bvh, cuda_device):
    """K2 on its persistent grid, where path lengths are most uneven
    (Cornell, Russian roulette from bounce 2, the sky off), without and with
    the tile-BVH walk: below one resident grid (1,000 rays; 4,001, not a
    multiple of 32) and above it (512x512, about two rays a lane, so lanes
    start new rays mid-launch). Bit for bit against the plain version."""
    scene, camera = tpresets.cornell_box()
    scene = finalize(scene, use_bvh=use_bvh)
    cfg = RenderConfig(width=512, height=512, spp=1, bounces=10,
                       russian_roulette=True, rr_start_bounce=2,
                       sky_background=False)
    rays, ctx = _head(*tcam.generate_rays(
        tcam.derive(camera, 1.0), threefry.split(threefry.key(9), 1)[0], 512, 512,
        device=cuda_device), n)
    before = (bk.PATH_LAUNCHES, bk.PATH_BVH_LAUNCHES)
    out = bk.path_trace(scene.packed, rays, ctx, cfg)
    assert (bk.PATH_LAUNCHES, bk.PATH_BVH_LAUNCHES) == (before[0] + 1,
                                                        before[1] + use_bvh)
    assert torch.equal(out, bk.path_trace_reference(scene.packed, rays, ctx, cfg))
    assert float(out.sum()) > 0.0


@pytest.mark.cuda
def test_k2_zero_bounces_on_card(cuda_device):
    """K2 with no bounce writes zero radiance for every ray, as the plain
    version."""
    scene, rays, ctx = _primary("cornell_box", 32, cuda_device)
    cfg = RenderConfig(width=32, height=32, spp=1, bounces=0)
    out = bk.path_trace(scene.packed, rays, ctx, cfg)
    assert torch.equal(out, bk.path_trace_reference(scene.packed, rays, ctx, cfg))
    assert not bool(out.any())


@pytest.mark.cuda
def test_scene_file_on_card_matches_cpu(cuda_device, tmp_path):
    """`render --scene scenes/cornellbox.yaml` on the card: the film of the
    loaded scene at 64x64 against the same render on the CPU (1e-4 but for
    at most 1 value in 10^4), and the CLI's PNG against the CPU's."""
    import pathlib

    from raytracingthenextweekcuda_tpu_torch import cli
    from raytracingthenextweekcuda_tpu_torch.io.image import read_png
    from raytracingthenextweekcuda_tpu_torch.io.yaml_scene import load_scene

    path = str(pathlib.Path(__file__).resolve().parents[1] / "scenes" / "cornellbox.yaml")
    scene, camera = load_scene(path)
    scene = finalize(scene)
    cfg = RenderConfig(width=64, height=64, spp=4, bounces=10)
    before = bk.KERNEL_LAUNCHES
    card = integrator.render(scene, camera, cfg, device=cuda_device).accum.cpu().numpy()
    assert bk.KERNEL_LAUNCHES == before + 1
    cpu = integrator.render(scene, camera, cfg, device="cpu").accum.numpy()
    assert (~np.isclose(card, cpu, rtol=1e-4, atol=1e-4)).mean() <= 1e-4
    pngs = []
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.png"
        assert cli.main(["render", "--scene", path, "--width", "64", "--height", "64",
                         "--spp", "4", "--device", device, "--out", str(out)]) == 0
        pngs.append(read_png(str(out)).astype(int))
    assert (pngs[0] != pngs[1]).mean() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["cornell_box", "mesh_showcase"])
def test_sharded_render_on_card_matches_single_device(preset, cuda_device):
    """Tiles of cuda:0 run one after another (K1 over each tile's pixel ids
    on Cornell, the sorted wavefront on the tile-BVH mesh): the assembled
    pass equals render_pass on the card bit for bit."""
    from raytracingthenextweekcuda_tpu_torch.parallel.mesh import make_mesh
    from raytracingthenextweekcuda_tpu_torch.parallel.render import render_pass_sharded

    scene, camera = getattr(tpresets, preset)()
    scene = finalize(scene)
    cfg = RenderConfig(width=48, height=32, spp=2, bounces=5)
    key = threefry.key(8)
    single = integrator.render_pass(scene, camera, key, cfg, 2, device=cuda_device)
    for n in (1, 2, 4):
        out = render_pass_sharded(scene, camera, key, cfg, 2,
                                  make_mesh(n, [cuda_device] * n))
        assert torch.equal(out, single)
