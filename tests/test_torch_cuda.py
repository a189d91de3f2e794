"""K1, K2, K0, K3 and K4 against their plain versions on a CUDA card (K1,
K2 and K0 at rtol = atol = 1e-4, also on tile-BVH packs; K1 bit for bit
where path lengths are most uneven; K1, K2 and K0 with the tile-BVH walk bit
for bit on warps that walk with part of their lanes and on ties between
leaves; K2 bit for bit on its persistent grid below and above one
resident grid, K0 from below a warp to above a resident grid; K3 and K4
bit for bit, K4 also for every count of rays that need a leaf, on rays
that enter none, one, some and every 32-column chunk of a leaf (a partial
last chunk among them), on ties in one chunk, between chunks and between
leaves, on leaves the re-check skips mid list, and on the benchmark
mesh's wavefronts, and K4's stats counters equal to the plain version's;
the work-list kernel's lists equal to its plain torch loop's, from 1 to
16,384 leaves and on blocks that list every leaf; K1 bit for bit on the
488 spheres of the RTiOW final scene; on the 2,247,192 triangles of the
materialball_x48 scene (past the JAX package's frustum line), the
work-list kernel's lists equal to its plain version's on sampled blocks,
K4's winners on the frustum lists equal to those on the kernel's and to
its plain version's on sampled blocks, and the kernel launched once a
bounce with no frustum span; the shade
kernel bit for bit against its plain torch version on wavefronts with dead
rays, with and without Russian roulette and the sky, on all 8 material
kinds and without Lambertian, over a whole sorted image, and out of the
way of run_fit_mesh's gradient), renders (and
one backward of the differentiable wavefront and of the LBVH regime, and a
scene file through `render --scene`) on the card
against the same on the CPU, tile-sharded passes on the card against
render_pass there, and the benchmark line (`run_bench(mesh=True)`: its
FP32 share in (0, 1.05] and the three mesh metrics). These tests skip
without a card. The file imports no
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
from raytracingthenextweekcuda_tpu_torch.ops.cuda.launch import LAUNCHES
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
    before = LAUNCHES["K1"]
    k1 = bk.render_kernel(inp).cpu().numpy()
    plain = bk.render_reference(inp).cpu().numpy()
    assert LAUNCHES["K1"] == before + 1
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
    before = LAUNCHES["K1"]
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert LAUNCHES["K1"] == before + 2  # one launch per pass
    cpu = integrator.render(scene, camera, cfg, device="cpu")
    np.testing.assert_allclose(card.accum.cpu().numpy(), cpu.accum.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mesh_scene():
    scene, camera = tpresets.mesh_showcase(16, 32)
    return finalize(scene), camera


def _mesh_wavefront(scene, camera, device, bounces, size=64):
    """A size x size, 2-spp wavefront of the tile-BVH mesh after `bounces`
    bounces of the sorted engine, on `device`: (DeviceScene, rays, alive)."""
    from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene
    from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table

    cfg = RenderConfig(width=size, height=size, spp=2, bounces=4)
    words = threefry.split(threefry.key(11), 2)
    ds = device_scene(scene, device)
    rays, ctx = tcam.generate_rays_multi(tcam.derive(camera, 1.0), words, size,
                                         size, device)
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
    before = (LAUNCHES["K3"], LAUNCHES["K4"])
    t, code = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
    t_p, code_p = k3.closest_hit_reference(rays.origin, rays.direction,
                                           rays.time, alive, ds.analytic, EPSILON)
    assert torch.equal(code, code_p) and torch.equal(t, t_p)
    alive_mesh, t_cap = mesh_query(ds.leaves, rays, EPSILON, alive, t, code)
    before_wl = LAUNCHES["worklist"]
    args = k4.winner_inputs(rays, ds.leaves, EPSILON, alive_mesh, t_cap)
    assert LAUNCHES["worklist"] == before_wl + 1
    t4, c4 = k4.winner(*args, ds.leaves, EPSILON)
    t4p, c4p = k4.winner_reference(*args, ds.leaves, EPSILON)
    assert torch.equal(c4, c4p) and torch.equal(t4, t4p)
    assert int((c4 >= 0).sum()) > 0
    assert (LAUNCHES["K3"], LAUNCHES["K4"]) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_mesh_render_on_card_matches_cpu(cuda_device, mesh_scene):
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3

    scene, camera = mesh_scene
    cfg = RenderConfig(width=24, height=16, spp=4, bounces=5, spp_per_pass=2,
                       russian_roulette=True, rr_start_bounce=2)
    before = (LAUNCHES["K3"], LAUNCHES["K4"])
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert LAUNCHES["K3"] > before[0] and LAUNCHES["K4"] > before[1]
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
    before = LAUNCHES["K2"]
    k2 = bk.path_trace(scene.packed, rays, ctx, cfg).cpu().numpy()
    plain = bk.path_trace_reference(scene.packed, rays, ctx, cfg).cpu().numpy()
    assert LAUNCHES["K2"] == before + 1
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
    before = LAUNCHES["K0"]
    k0 = bk.bounce_step(scene.packed, state, u4, do_rr, cfg)
    plain = bk.bounce_step_reference(scene.packed, state, u4, do_rr, cfg)
    assert LAUNCHES["K0"] == before + 1
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
    before = LAUNCHES["K0"]
    k0 = bk.bounce_step(scene.packed, state, u4, do_rr, cfg)
    plain = bk.bounce_step_reference(scene.packed, state, u4, do_rr, cfg)
    assert LAUNCHES["K0"] == before + 1
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
    before = (LAUNCHES["K1-BVH"], LAUNCHES["K2-BVH"], LAUNCHES["K0-BVH"])
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
    assert (LAUNCHES["K1-BVH"], LAUNCHES["K2-BVH"],
            LAUNCHES["K0-BVH"]) == tuple(b + 1 for b in before)


@pytest.mark.cuda
def test_forced_megastep_on_card_matches_cpu(cuda_device, mesh_scene, monkeypatch):
    """The forced megastep route (K1 with its tile-BVH walk) on the card
    against the same route on the CPU."""
    scene, camera = mesh_scene
    monkeypatch.setattr(integrator, "_sorted_eligible", lambda *_: False)
    cfg = RenderConfig(width=24, height=16, spp=4, bounces=5, spp_per_pass=2)
    before = LAUNCHES["K1-BVH"]
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    assert LAUNCHES["K1-BVH"] == before + 2
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
    before = LAUNCHES["K4"]
    out = k4.winner(*args, leaves, EPSILON)
    assert LAUNCHES["K4"] == before + 1
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
    rays need the one leaf (the rest are dead): from one listed ray, which
    one warp takes while three idle, to 128, 32 rays a warp."""
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
    skips them mid list. K4 still equals its plain version bit for bit."""
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
    before = (LAUNCHES["K4"], LAUNCHES["K4-stats"])
    t_s, c_s, st = k4.winner(*args, leaves, EPSILON, stats=True)
    assert (LAUNCHES["K4"], LAUNCHES["K4-stats"]) == (before[0], before[1] + 1)
    _, _, st_p = k4.winner_reference(*args, leaves, EPSILON, stats=True)
    assert torch.equal(t_s, t) and torch.equal(c_s, c)
    assert st.dtype == torch.int32 and st.shape == (args[4].counts.shape[0], 2)
    assert torch.equal(st.cpu(), st_p.cpu())
    assert (st[:, 1] < st[:, 0]).any()


def _hand_leaves(tiles, device):
    """A LeafScene of hand-ordered leaves: leaf l's tile holds the
    triangles tiles[l] (k, 3, 3) in that column order, zero-padded to the
    768 columns of finalize's tiles, with its box and its chunk boxes as
    finalize builds them (no tile-BVH builder reorders them)."""
    from types import SimpleNamespace

    from raytracingthenextweekcuda_tpu_torch.models.scene import (
        LEAF_WIDTH,
        SceneBuilder,
    )
    from raytracingthenextweekcuda_tpu_torch.ops.bvh_tile import chunk_bounds
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    width = LEAF_WIDTH
    verts = np.zeros((len(tiles) * width, 3, 3), np.float32)
    boxes = []
    for leaf, tri in enumerate(tiles):
        verts[leaf * width: leaf * width + len(tri)] = tri
        boxes.append(np.concatenate([tri.min(axis=(0, 1)), tri.max(axis=(0, 1))]))
    b = SceneBuilder()
    b.lambertian(0, (0.5, 0.5, 0.5))
    b.mesh(verts[:1], 0)
    v0 = verts[:, 0]
    trih = bk._pack_havel(v0, verts[:, 1] - v0, verts[:, 2] - v0,
                          np.zeros(len(verts), np.int32),
                          b.build().materials)[:, :len(verts)]
    packed = SimpleNamespace(
        leaf_bounds=np.stack(boxes, axis=1).astype(np.float32),
        leaf_tiles=(np.arange(len(tiles), dtype=np.int32) * width)[None],
        trih=trih, chunk_bounds=chunk_bounds(verts, trih[:12], width))
    return k4.leaf_scene(packed, device)


def _quad_x(x):
    """(2, 3, 3): the square [-1, 1]^2 of the plane at `x`, its two
    triangles facing -x."""
    a, b, c, d = ((x, -1, -1), (x, 1, -1), (x, 1, 1), (x, -1, 1))
    return np.asarray([(a, d, c), (a, c, b)], np.float32)


def _k4_hand(tiles, o, d, device, t_cap=None):
    """K4 and its plain version on `_hand_leaves(tiles)` for rays (o, d):
    ((t, code), (t, code) plain, leaves); one launch of K4."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    leaves = _hand_leaves(tiles, device)
    n = o.shape[0]
    rays = Rays(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
                torch.zeros(n, device=device))
    cap = None if t_cap is None else torch.from_numpy(t_cap).to(device)
    args = k4.winner_inputs(rays, leaves, EPSILON, t_cap=cap)
    before = LAUNCHES["K4"]
    out = k4.winner(*args, leaves, EPSILON)
    assert LAUNCHES["K4"] == before + 1
    return out, k4.winner_reference(*args, leaves, EPSILON), leaves


@pytest.mark.cuda
def test_k4_chunk_entries_match_plain_on_card(cuda_device):
    """Venetian blinds in one leaf: 16 squares facing -x at x in [0, 0.015]
    (chunk 0) and 235 at x in [0.5, 0.968] (chunks 1 to 15, the last one
    of 22 columns: 502 is no multiple of 32). Rays that enter every chunk
    (+x from x = -1), one (the same, capped at x = 0.2 by their analytic
    ceiling; or +x from x = 0.947, the partial chunk only), 15 (+x from x
    = 0.3) and none though they enter the leaf box (+y through the gap),
    mixed in every block: K4 bit for bit against its plain version, which
    scans every column."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import safe_inv

    tri = np.concatenate([_quad_x(0.001 * i) for i in range(16)]
                         + [_quad_x(0.5 + 0.002 * i) for i in range(235)])
    g = np.random.default_rng(21)
    n = 128 * 8
    kind = g.integers(0, 5, n)
    yz = g.uniform(-0.9, 0.9, (n, 2))
    start = np.asarray([-1.0, -1.0, 0.947, 0.3, 0.3])[kind]
    o = np.concatenate([start[:, None], yz], axis=1)
    d = np.tile(np.float64([1.0, 0.0, 0.0]), (n, 1))
    gap = kind == 4
    o[gap] = np.stack([np.full(gap.sum(), 0.3), np.full(gap.sum(), -3.0),
                       yz[gap, 1]], axis=1)
    d[gap] = (0.0, 1.0, 0.0)
    d[~gap, 1:] = g.uniform(-0.02, 0.02, (int((~gap).sum()), 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    cap = np.where(kind == 1, 1.2, 3e38).astype(np.float32)
    (t, c), (tp, cp), leaves = _k4_hand([tri], o, d, cuda_device, t_cap=cap)
    assert torch.equal(c, cp) and torch.equal(t, tp)
    assert int(leaves.leaf_count[0]) == 502
    enters = k4.chunk_entries(leaves.chunk_bounds[0][:, None, :].cpu(),
                              torch.from_numpy(o), safe_inv(torch.from_numpy(d)),
                              torch.from_numpy(cap), EPSILON)[:, :16].sum(dim=1)
    for k, chunks in enumerate((16, 1, 1, 15, 0)):
        assert (enters[torch.from_numpy(kind == k)] == chunks).all(), k
    col = (c.cpu() & 0xFFFFFF).numpy()
    hit = c.cpu().numpy() >= 0
    assert hit[kind < 4].all() and not hit[kind == 4].any()
    assert (col[kind < 2] < 32).all() and (col[kind == 2] >= 480).all()
    assert ((col[kind == 3] >= 32) & (col[kind == 3] < 64)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("between", ["chunks", "leaves"])
def test_k4_ties_between_chunks_and_leaves_on_card(between, cuda_device):
    """Equal t in two chunks of one leaf (a 4x4 grid of squares facing -x,
    32 columns, and its copy in the next 32), or in two leaves (the grid in
    each): K4 equals its plain version bit for bit, and the lower column,
    or the leaf the block's list holds first, wins, as in the sequential
    scan."""
    cells = []
    for i in range(4):
        for j in range(4):
            q = _quad_x(0.0)
            q[:, :, 1] = -1 + 0.5 * i + (q[:, :, 1] + 1) * 0.25
            q[:, :, 2] = -1 + 0.5 * j + (q[:, :, 2] + 1) * 0.25
            cells.append(q)
    grid = np.concatenate(cells)
    tiles = [np.concatenate([grid, grid])] if between == "chunks" else [grid, grid]
    g = np.random.default_rng(22)
    n = 128 * 8
    o = np.concatenate([np.full((n, 1), -2.0), g.uniform(-0.95, 0.95, (n, 2))], 1)
    d = np.concatenate([np.ones((n, 1)), g.uniform(-0.1, 0.1, (n, 2))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (t, c), (tp, cp), _ = _k4_hand(tiles, o.astype(np.float32),
                                   d.astype(np.float32), cuda_device)
    assert torch.equal(c, cp) and torch.equal(t, tp)
    col = (c.cpu() & 0xFFFFFF).numpy()
    assert int((c >= 0).sum()) > 0.9 * n
    assert (col[c.cpu().numpy() >= 0] < 32).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [0, 2], ids=["primary", "bounce2"])
def test_k4_matches_plain_on_benchmark_mesh(bounces, cuda_device):
    """K4 bit for bit against its plain version on the benchmark's mesh
    (benchmark/configs/mesh_stress: 46,840 triangles, 84 leaves) at
    128x128, 2 spp: its primary and bounce-2 wavefronts."""
    from benchmark import program, scenedata
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
    from raytracingthenextweekcuda_tpu_torch.ops.fused import mesh_query

    scene, camera = program.build_scene(scenedata.load_config("mesh_stress"))
    ds, rays, alive = _mesh_wavefront(finalize(scene), camera, cuda_device, bounces,
                                      size=128)
    assert ds.leaves.n_leaves == 84
    t, code = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
    alive_mesh, t_cap = mesh_query(ds.leaves, rays, EPSILON, alive, t, code)
    args = k4.winner_inputs(rays, ds.leaves, EPSILON, alive_mesh, t_cap)
    t4, c4 = k4.winner(*args, ds.leaves, EPSILON)
    t4p, c4p = k4.winner_reference(*args, ds.leaves, EPSILON)
    assert torch.equal(c4, c4p) and torch.equal(t4, t4p)
    assert int((c4 >= 0).sum()) > 0


def _leaf_boxes(n_leaves, n_rays, seed, device, twins=False, hub=False):
    """build_worklist's exact-pass inputs on `device`: `n_leaves` random
    boxes in [-1, 1]^3 (leaves 0 and 1 the same box with `twins`; every box
    widened to hold the origin with `hub`, and the 128 rays of block 3
    live and starting there, so that they hit every leaf) and `n_rays`
    rays aimed into them, a fifth dead, two blocks wholly dead, some
    direction components exactly +-0, one live ray with a NaN origin
    coordinate, random ceilings: (origin, direction, alive, tcap,
    leaf_bounds)."""
    g = np.random.default_rng(seed)
    c = g.uniform(-1, 1, (n_leaves, 3))
    h = g.uniform(0.02, 0.3, (n_leaves, 3))
    if hub:
        h = np.maximum(h, np.abs(c) + 0.01)
    lb = np.concatenate([c - h, c + h], axis=1).T.astype(np.float32)
    if twins:
        lb[:, 1] = lb[:, 0]
    o = g.uniform(-3, 3, (n_rays, 3))
    d = g.uniform(-1, 1, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 0] = 0.0
    d[3::11, 1] = -0.0
    alive = g.random(n_rays) > 0.2
    alive[128:384] = False
    o[5, 2], alive[5] = np.nan, True
    if hub:
        o[384:512], alive[384:512] = 0.0, True
    tcap = g.uniform(1.0, 6.0, n_rays)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (
        o.astype(np.float32), d.astype(np.float32), alive, tcap.astype(np.float32),
        lb))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "primary", "primary_tcap", "bounce1", "bounce1_tcap", "leaves_1", "leaves_84",
    "leaves_340", "leaves_2048", "twin_leaves", "leaves_2049", "leaves_4336",
    "leaves_16384", "hub_2049", "hub_4336", "hub_16384", "leaves_16385",
    "hub_163840"])
def test_worklist_kernel_matches_plain_on_card(case, cuda_device, mesh_scene):
    """The exact work-list pass, one launch of its kernel a build, against
    its plain torch loop on the same CUDA inputs: counts and order bit for
    bit, entry equal in value. The mesh stand-in's primary and bounce-1
    wavefronts (with and without the analytic ceilings), and random leaf
    boxes at 1 (one group), 84 (the benchmark's mesh), 340 (mesh_large),
    2048 (the JAX package's frustum line), 2049, 4336 (materialball_x48),
    16384 and 16385 leaves with dead rays and dead blocks; at 2049 to
    163840 also a block whose rays hit every leaf, past the sort keys the
    kernel keeps in shared memory (at 163840 its group words alone pass
    the 48 KB a launch gets without raising its limit); two leaves with
    the same box, whose tied entries keep leaf order."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
    from raytracingthenextweekcuda_tpu_torch.ops.fused import mesh_query

    wavefront = case.startswith(("primary", "bounce1"))
    if wavefront:
        ds, rays, alive = _mesh_wavefront(*mesh_scene, cuda_device,
                                          0 if case.startswith("primary") else 1)
        t, code = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
        alive_mesh, t_cap = mesh_query(ds.leaves, rays, EPSILON, alive, t, code)
        o, d, a, tcap, _ = k4.winner_inputs(rays, ds.leaves, EPSILON, alive_mesh,
                                            t_cap)
        lb = ds.leaves.leaf_bounds
    else:
        n_leaves = 2 if case == "twin_leaves" else int(case.split("_")[1])
        o, d, a, tcap, lb = _leaf_boxes(n_leaves, 128 * 32, n_leaves, cuda_device,
                                        twins=case == "twin_leaves",
                                        hub=case.startswith("hub"))
    cap = None if wavefront and not case.endswith("tcap") else tcap
    before = LAUNCHES["worklist"]
    wl = k4.build_worklist(o, d, a, lb, EPSILON, tcap=cap)
    assert LAUNCHES["worklist"] == before + 1
    plain = k4.worklist_reference(o, d, a, tcap if cap is not None else
                                  torch.full_like(tcap, k3.BIG), lb, EPSILON)
    assert wl.order.shape == plain.order.shape == (o.shape[0] // 128, lb.shape[1])
    assert torch.equal(wl.counts, plain.counts)
    assert torch.equal(wl.order, plain.order)
    assert torch.equal(wl.entry, plain.entry)
    assert int(wl.counts.sum()) > 0
    if not wavefront:
        assert int(wl.counts[1:3].sum()) == 0  # the dead blocks list nothing
    if case.startswith("hub"):
        assert int(wl.counts[3]) == n_leaves
    if case == "twin_leaves":
        both = (wl.counts == 2).nonzero().flatten()
        assert both.numel() > 0
        assert torch.equal(wl.order[both], torch.tensor(
            [[0, 1]], dtype=torch.int32, device=cuda_device).expand(both.numel(), 2))
        assert torch.equal(wl.entry[both, 0], wl.entry[both, 1])


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
    before = LAUNCHES["K1-BVH"]
    k1 = bk.render_kernel(inp).cpu().numpy()
    assert LAUNCHES["K1-BVH"] == before + use_bvh
    np.testing.assert_array_equal(k1, bk.render_reference(inp).cpu().numpy())


@pytest.mark.cuda
def test_k1_matches_plain_on_rtiow_final(cuda_device):
    """K1 against its plain version on a band of the RTiOW final scene at its
    published 1200x800 and 50 bounces: all 488 spheres staged in shared
    memory (35,136 B), 385 of them moving over the shutter, the thin lens
    of aperture 0.1; the band's primaries hit moving spheres. Equal bit for
    bit."""
    scene, camera = tpresets.rtiow_final(seed=0)
    scene = finalize(scene)
    cfg = RenderConfig(width=1200, height=800, spp=4, bounces=50, spp_per_pass=4)
    band = np.arange(384 * 1200, 416 * 1200)
    inp = bk.render_inputs(scene.packed, tcam.derive(camera, cfg.aspect_ratio),
                           threefry.split(threefry.key(11), 4), cfg,
                           pixel_ids=band, device=cuda_device)
    assert inp.trih is None and inp.counts == (488, 0, 0, 0, 0)
    assert int((scene.spheres.center1 != scene.spheres.center0).any(axis=1).sum()) == 385
    before = LAUNCHES["K1"]
    k1 = bk.render_kernel(inp).cpu().numpy()
    assert LAUNCHES["K1"] == before + 1
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
    before = (LAUNCHES["K1-BVH"], LAUNCHES["K2-BVH"], LAUNCHES["K0-BVH"])
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
    assert (LAUNCHES["K1-BVH"], LAUNCHES["K2-BVH"],
            LAUNCHES["K0-BVH"]) == tuple(b + 1 for b in before)


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
    before = (LAUNCHES["K2"], LAUNCHES["K2-BVH"])
    out = bk.path_trace(scene.packed, rays, ctx, cfg)
    assert (LAUNCHES["K2"], LAUNCHES["K2-BVH"]) == (before[0] + 1,
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
    before = LAUNCHES["K1"]
    card = integrator.render(scene, camera, cfg, device=cuda_device).accum.cpu().numpy()
    assert LAUNCHES["K1"] == before + 1
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


@pytest.mark.cuda
def test_bench_line_on_card(cuda_device):
    """`run_bench(mesh=True)`: the headline's share of the card's FP32 lane
    rate by the reference's op model lies in (0, 1.05], and the line
    carries the three mesh metrics."""
    from raytracingthenextweekcuda_tpu_torch.apps import bench

    line = bench.run_bench(device=cuda_device, mesh=True)
    assert 0 < line["fp32_util"] <= 1.05 and line["fp32_peak_ops"] > 0
    for key in ("mesh_bvh", "mesh_stress", "mesh_large"):
        assert line[key]["paths_per_sec"] > 0


@pytest.fixture(scope="module")
def stress_scene():
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes

    scene, camera, _ = bench_scenes.stress_mesh_scene()
    return finalize(scene), camera


def _all_kinds_scene():
    """A tile-BVH scene that uses all 8 material kinds: a coat mesh (576
    triangles), metal, glass (one hollow), Phong, mirror and smallpt-glass
    spheres (one moving), a light, and a wall with additive emission."""
    from raytracingthenextweekcuda_tpu_torch.io.procedural import uv_sphere_mesh
    from raytracingthenextweekcuda_tpu_torch.models.scene import SceneBuilder
    from raytracingthenextweekcuda_tpu_torch.ops import geometry as g

    b = SceneBuilder()
    b.lambertian(0, (0.7, 0.6, 0.5))
    b.metal(1, (0.8, 0.8, 0.7), 0.3)
    b.dielectric(2, 1.5)
    b.emission(3, (1.0, 0.9, 0.8), 4.0)
    b.phong_metal(4, (0.9, 0.6, 0.3), 30.0)
    b.specular(5, (0.9, 0.9, 0.9))
    b.coat(6, (0.2, 0.5, 0.8))
    b.refraction(7, 1.5)
    b.material(8, g.LAMBERTIAN, (0.5, 0.5, 0.5), emission=(0.3, 0.2, 0.1))
    sphere = uv_sphere_mesh(0.3, (0.0, 0.0, -0.5), 12, 24)
    b.mesh(np.ascontiguousarray(sphere[:, ::-1]), 6)
    b.sphere((-0.75, 0.0, -0.5), 0.3, 1)
    b.sphere((0.75, 0.0, -0.5), 0.3, 2)
    b.sphere((0.75, 0.0, -0.5), -0.27, 2)
    b.moving_sphere((-0.4, 0.5, -0.8), (-0.3, 0.6, -0.8), 0.0, 1.0, 0.2, 4)
    b.sphere((0.4, 0.5, -0.9), 0.2, 5)
    b.sphere((0.0, -0.3, 0.2), 0.15, 7)
    b.plane((0.0, -0.5, 0.0), (0.0, 1.0, 0.0), (3.0, 0.0, 3.0), g.PLANE_XZ, 0)
    b.plane((0.0, 1.2, -0.5), (0.0, 1.0, 0.0), (0.6, 0.0, 0.6), g.PLANE_XZ, 3,
            two_sided=False)
    b.plane((0.0, 0.0, -1.6), (0.0, 0.0, 1.0), (3.0, 3.0, 0.0), g.PLANE_XY, 8)
    camera = tcam.Camera.make(eye=(0.0, 0.3, 1.6), center=(0.0, 0.0, -0.4), fov=60.0,
                              aperture=0.0, focus_distance=1.9, time1=1.0)
    scene = finalize(b.build())
    assert scene.packed.leaf_bounds is not None
    assert set(scene.packed.used_kinds) == set(range(8))
    return scene, camera


def _shade_front(scene, camera, device, cfg, bounce, size=128, samples=2):
    """The sorted engine's wavefront at bounce `bounce` of a 2-sample pass,
    on `device`: the torch body before it, and before each later bounce a
    sort that keeps the dead rays (misses and ended paths) at the tail.
    Returns (ds, mats, state, winners, slot tables, slots)."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import shade_kernel as sk
    from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene, winners
    from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table
    from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import ray_sort_key

    words = threefry.split(threefry.key(13), samples)
    rays, _ = tcam.generate_rays_multi(tcam.derive(camera, 1.0), words, size, size,
                                       device)
    tb0, tb1 = rng.key_bases(words, device)
    ctx = rng.SlotCtx(None, tb0, tb1, size * size, size * size)
    ds = device_scene(scene, device)
    mats = material_table(scene.materials, device)
    n = rays.count
    state = (rays, torch.ones((n, 3), device=device), torch.zeros((n, 3), device=device),
             torch.ones((n,), dtype=torch.bool, device=device))
    slot = torch.arange(n, device=device)
    bounds = torch.from_numpy(scene.packed.bvh_bounds[:, 0].copy()).to(device)
    for b in range(bounce + 1):
        if b:
            key = ray_sort_key(state[0].origin, state[0].direction, state[3],
                               bounds[0:3], bounds[3:6])
            perm = torch.argsort(key, stable=True)
            state = (state[0].take(perm), state[1][perm], state[2][perm],
                     state[3][perm])
            slot = slot[perm]
        win = winners(ds, state[0], cfg.tmin, alive=state[3])
        if b < bounce:
            state = sk.shade_reference(ds, mats, scene.packed.used_kinds, cfg, state,
                                       win, ctx, slot, b)
    return ds, mats, state, win, ctx, slot


def _bit_equal(name, out, plain):
    """The shade kernel's state against its plain version's, bit for bit:
    rays, throughput, radiance and alive flags."""
    rows = (("origin", out[0].origin, plain[0].origin),
            ("direction", out[0].direction, plain[0].direction),
            ("time", out[0].time, plain[0].time), ("throughput", out[1], plain[1]),
            ("radiance", out[2], plain[2]))
    for what, a, b in rows:
        assert bool(torch.isfinite(b).all()), f"{name} {what}: plain not finite"
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            diff = (a.double() - b.double()).abs()
            raise AssertionError(f"{name} {what}: {int((a != b).sum())} values differ, "
                                 f"max |diff| {float(diff.max())}")
    assert torch.equal(out[3], plain[3]), f"{name}: alive flags differ"


@pytest.mark.cuda
@pytest.mark.parametrize("sky", [True, False], ids=["sky", "no_sky"])
@pytest.mark.parametrize("rr", [False, True], ids=["no_rr", "rr"])
@pytest.mark.parametrize("bounce", [0, 2], ids=["primary", "sorted"])
def test_shade_kernel_matches_plain_on_card(bounce, rr, sky, cuda_device,
                                            stress_scene):
    """The shade kernel against its plain torch version on the mesh stress
    stand-in's wavefronts: the primary one, with a tenth of its rays dead,
    and one after two bounces and a sort, whose dead rays sit at its tail."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import shade_kernel as sk

    scene, camera = stress_scene
    cfg = RenderConfig(russian_roulette=rr, rr_start_bounce=0, sky_background=sky)
    ds, mats, state, win, ctx, slot = _shade_front(scene, camera, cuda_device, cfg,
                                                   bounce)
    if bounce == 0:
        keep = torch.rand(state[3].shape, generator=torch.Generator().manual_seed(3))
        state = (*state[:3], (keep > 0.1).to(cuda_device))
    dead = int((~state[3]).sum())
    assert dead > 0 and int((win.c_m >= 0).sum()) > 0
    used = scene.packed.used_kinds
    before = LAUNCHES["shade"]
    out = sk.shade(ds, mats, used, cfg, state, win, ctx, slot, bounce)
    assert LAUNCHES["shade"] == before + 1
    plain = sk.shade_reference(ds, mats, used, cfg, state, win, ctx, slot, bounce)
    _bit_equal(f"bounce {bounce}", out, plain)
    assert bool(out[3].any()) and not bool(out[3][~state[3]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("used", ["scene", "no_lambertian"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_shade_kernel_all_material_kinds_on_card(bounce, used, cuda_device):
    """Every material kind, and the kinds a scene leaves out take the
    plain version's defaults: without Lambertian the direction is the
    normal."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import shade_kernel as sk

    scene, camera = _all_kinds_scene()
    cfg = RenderConfig(russian_roulette=True, rr_start_bounce=1)
    ds, mats, state, win, ctx, slot = _shade_front(scene, camera, cuda_device, cfg,
                                                   bounce)
    kinds = tuple(range(8)) if used == "scene" else tuple(range(1, 8))
    code = torch.where((win.c_m >= 0) & ((win.t_m < win.t) | (win.code < 0)),
                       win.c_m, win.code)
    assert {1, 2, 3} <= set((code[code >= 0] >> 24).unique().tolist())
    out = sk.shade(ds, mats, kinds, cfg, state, win, ctx, slot, bounce)
    plain = sk.shade_reference(ds, mats, kinds, cfg, state, win, ctx, slot, bounce)
    _bit_equal(f"{used} bounce {bounce}", out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["stress", "all_kinds"])
def test_sorted_render_with_shade_kernel_matches_plain(which, cuda_device,
                                                       stress_scene, monkeypatch):
    """A whole `_trace_sorted` image: with the shade kernel against the
    torch body on the card, bit for bit, one launch a bounce."""

    scene, camera = stress_scene if which == "stress" else _all_kinds_scene()
    cfg = RenderConfig(width=64, height=48, spp=4, bounces=6, spp_per_pass=2,
                       russian_roulette=True, rr_start_bounce=2)
    before = LAUNCHES["shade"]
    card = integrator.render(scene, camera, cfg, device=cuda_device)
    launches = LAUNCHES["shade"] - before
    assert 2 <= launches <= 2 * cfg.bounces
    monkeypatch.setattr(integrator, "_kernel_shades", lambda *args: False)
    plain = integrator.render(scene, camera, cfg, device=cuda_device)
    assert LAUNCHES["shade"] == before + launches
    assert torch.equal(card.accum.view(torch.int32), plain.accum.view(torch.int32))
    assert float(card.accum.sum()) > 0


@pytest.mark.cuda
def test_fit_mesh_on_card_takes_the_torch_body_for_its_gradient(cuda_device,
                                                                monkeypatch,
                                                                tmp_path):
    """run_fit_mesh on the card: the renders under grad take the torch body
    (no shade launch), and a few steps give the same losses with the shade
    kernel in the no-grad renders as with the torch body everywhere."""
    from raytracingthenextweekcuda_tpu_torch.apps import fit

    size, spp = 24, 2
    cfg = fit.fit_config(size, size, spp)
    key = threefry.key(0)
    anchor = fit.refinalize(fit.make_mesh_scene(), np.zeros(3, np.float32))
    with torch.no_grad():
        target = integrator.render_gbuffer(anchor, fit.fit_camera(), key, cfg, spp,
                                           device=cuda_device)
    scale = torch.tensor([0.02, -0.03, 0.01], device=cuda_device, requires_grad=True)
    before = LAUNCHES["shade"]
    fit.mesh_fit_loss(scale, anchor, torch.zeros(3, device=cuda_device), target,
                      fit.fit_camera(), key, cfg, spp, cuda_device).backward()
    assert LAUNCHES["shade"] == before
    assert bool(torch.isfinite(scale.grad).all()) and float(scale.grad.abs().max()) > 0
    runs = {}
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(integrator, "_kernel_shades", lambda *args: False)
        losses, before = [], LAUNCHES["shade"]
        fit.run_fit_mesh(steps=3, out=str(tmp_path / f"fit_{kernel}.png"), width=size,
                         height=size, spp=spp, refresh=2, device=cuda_device,
                         verbose=False, losses=losses)
        runs[kernel] = (losses, LAUNCHES["shade"] - before)
    assert runs[True][0] == runs[False][0] and len(runs[True][0]) == 3
    assert runs[True][1] > 0 and runs[False][1] == 0


@pytest.fixture(scope="module")
def materialball():
    """The `materialball_x48` configuration at full size (2,247,192
    triangles, past FRUSTUM_LEAF_THRESHOLD leaves) on the card, and the
    primary and bounce-2 wavefronts of its cell's job (512x512, 16 spp) as
    the sorted engine traces them: (scene, camera, DeviceScene, fronts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run only there")
    from benchmark import program, scenedata
    from chip_smoke import _wavefronts

    dev = torch.device("cuda", 0)
    scene, camera = program.build_scene(scenedata.load_config("materialball_x48"))
    scene = finalize(scene)
    cfg = RenderConfig(width=512, height=512, spp=16, bounces=5, spp_per_pass=16,
                       seed=23)
    ds, fronts = _wavefronts(scene, camera, cfg, 16, dev)
    return scene, camera, ds, dict((name, (rays, alive)) for name, rays, alive in fronts)


def _materialball_inputs(materialball, front):
    """K4's inputs on a materialball wavefront, with the lists the card's
    route takes, the work-list kernel's: (origin, direction, alive, tcap,
    WorkList)."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
    from raytracingthenextweekcuda_tpu_torch.ops.fused import mesh_query

    _, _, ds, fronts = materialball
    rays, alive = fronts[front]
    assert int((materialball[0].triangles.mesh_id >= 0).sum()) == 2247192
    assert k4.use_frustum_worklist(ds.leaves.n_leaves)
    assert not k4.use_frustum_route(ds.leaves.n_leaves, rays.origin.device)
    t, code = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
    alive_mesh, t_cap = mesh_query(ds.leaves, rays, EPSILON, alive, t, code)
    before = LAUNCHES["worklist"]
    out = k4.winner_inputs(rays, ds.leaves, EPSILON, alive_mesh, t_cap)
    assert LAUNCHES["worklist"] == before + 1
    return out


def _sampled_blocks(a, seed, n=24):
    """A seeded sample of `n` live 128-ray blocks of the alive mask `a` and
    their rows."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    live = torch.nonzero(a.view(-1, k4.BLOCK).any(dim=1)).flatten().cpu().numpy()
    pick = np.sort(np.random.default_rng(seed).choice(live, n, replace=False))
    blocks = torch.from_numpy(pick).to(a.device)
    rows = (blocks[:, None] * k4.BLOCK + torch.arange(k4.BLOCK, device=a.device)).flatten()
    return blocks, rows


@pytest.mark.cuda
@pytest.mark.parametrize("front", ["primary", "bounce2"])
def test_worklist_kernel_matches_plain_on_materialball_blocks(front, materialball):
    """On the full materialball_x48 scene (4,336 leaves, the group cull),
    the work-list kernel's lists of a seeded sample of 48 live blocks and
    the longest list equal its plain version's: counts and order bit for
    bit, entry in value; no leaf hit lies outside an entered group."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work

    leaves = materialball[2].leaves
    o, d, a, tcap, wl = _materialball_inputs(materialball, front)
    blocks, _ = _sampled_blocks(a, 24, 48)
    blocks = torch.unique(torch.cat([blocks, wl.counts.argmax().view(1)]))
    rows = (blocks[:, None] * k4.BLOCK + torch.arange(k4.BLOCK, device=o.device)).flatten()
    work.reset()
    plain = k4.worklist_reference(o[rows], d[rows], a[rows], tcap[rows], leaves,
                                  EPSILON)
    assert torch.equal(wl.counts[blocks], plain.counts)
    assert torch.equal(wl.order[blocks], plain.order)
    assert torch.equal(wl.entry[blocks], plain.entry)
    assert int(plain.counts.min()) > 0
    assert work.WORK["group_misses"] == 0
    assert 0 < work.WORK["group_leaf_tests"] < int(a[rows].sum()) * leaves.n_leaves


@pytest.mark.cuda
@pytest.mark.parametrize("front", ["primary", "bounce2"])
def test_frustum_lists_give_k4_the_exact_winners_on_materialball(front, materialball):
    """On the full materialball_x48 scene, K4 walking the frustum pass's
    lists finds the winners it finds on the work-list kernel's exact lists,
    bit for bit; every frustum list is at least as long as the exact one."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    leaves = materialball[2].leaves
    o, d, a, tcap, exact = _materialball_inputs(materialball, front)
    wl = k4.build_worklist(o, d, a, leaves.leaf_bounds, EPSILON, tcap=tcap,
                           frustum=True)
    assert bool((wl.counts >= exact.counts).all())
    t_f, c_f = k4.winner(o, d, a, tcap, wl, leaves, EPSILON)
    t_e, c_e = k4.winner(o, d, a, tcap, exact, leaves, EPSILON)
    assert torch.equal(c_f, c_e) and torch.equal(t_f, t_e)
    assert int((c_f >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("front", ["primary", "bounce2"])
def test_k4_matches_plain_on_materialball_blocks(front, materialball):
    """K4 on the route's lists (the work-list kernel's) bit for bit against
    its plain version on a seeded sample of 24 of the wavefront's live
    blocks (a block's winners depend on its own rays and list alone)."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    leaves = materialball[2].leaves
    o, d, a, tcap, wl = _materialball_inputs(materialball, front)
    t, code = k4.winner(o, d, a, tcap, wl, leaves, EPSILON)
    blocks, rows = _sampled_blocks(a, 23)
    sub = k4.WorkList(wl.counts[blocks], wl.order[blocks], wl.entry[blocks])
    t_p, c_p = k4.winner_reference(o[rows], d[rows], a[rows], tcap[rows], sub, leaves,
                                   EPSILON)
    assert torch.equal(code[rows], c_p) and torch.equal(t[rows], t_p)
    assert int((c_p >= 0).sum()) > 0


@pytest.mark.cuda
def test_worklist_kernel_once_a_bounce_on_materialball(materialball):
    """A traced image of the cell's job on the card: no `k4.frustum` span
    and no frustum pair; the work-list kernel launches once a bounce, in
    `k4.worklist`, as K4 does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work

    scene, camera, _, _ = materialball
    cfg = RenderConfig(width=512, height=512, spp=16, bounces=5, spp_per_pass=16)
    integrator.render(scene, camera, cfg, device="cuda")
    torch.cuda.synchronize()
    before = (LAUNCHES["worklist"], LAUNCHES["K4"])
    work.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        integrator.render(scene, camera, cfg, device="cuda")
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:  # a range's GPU annotation
            continue
        if e.name in ("k4.frustum", "k4.worklist", "wavefront.bounce"):
            counts[e.name] = counts.get(e.name, 0) + 1
    launches = LAUNCHES["worklist"] - before[0]
    assert "k4.frustum" not in counts and work.WORK["frustum_pairs"] == 0
    assert counts["k4.worklist"] == counts["wavefront.bounce"] == launches
    assert launches == LAUNCHES["K4"] - before[1]
    assert 1 <= launches <= cfg.bounces
