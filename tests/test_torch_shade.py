"""The sorted wavefront's shading on the CPU: the plain version of the
shade kernel (ops/cuda/shade_kernel.shade_reference) against the
differentiable wavefront's bounce body on the same wavefronts, the choice
between the kernel and the torch body in `_trace_sorted` (CPU tensors and
gradients take the body), the slot tables of the random draws, the
kernel's flags and the launch's input checks. The kernel itself runs only
on a card (tests/test_torch_cuda.py).
"""

import types

import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu_torch.io.procedural import uv_sphere_mesh
from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as tcam
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    SceneBuilder,
    finalize,
    with_leaves,
)
from raytracingthenextweekcuda_tpu_torch.ops import geometry, rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import shade_kernel as sk
from raytracingthenextweekcuda_tpu_torch.ops.cuda.launch import LAUNCHES
from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene, winners
from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    scene, camera = presets.mesh_showcase(16, 32)
    cache = str(tmp_path_factory.mktemp("bvh_cache"))
    return finalize(scene, bvh_cache_dir=cache), camera


def _wavefront(scene, camera, size=16, samples=2):
    """The sample-major primary wavefront of `samples` samples, its slot
    tables and its per-ray RayCtx, on the CPU."""
    words = threefry.split(threefry.key(5), samples)
    rays, ray_ctx = tcam.generate_rays_multi(tcam.derive(camera, 1.0), words, size,
                                             size, "cpu")
    tb0, tb1 = rng.key_bases(words, "cpu")
    n = rays.count
    state = (rays, torch.ones((n, 3)), torch.zeros((n, 3)),
             torch.ones((n,), dtype=torch.bool))
    return state, rng.SlotCtx(None, tb0, tb1, size * size, size * size), ray_ctx


def _same(a, b):
    return torch.equal(a.contiguous().view(torch.int32 if a.is_floating_point()
                                           else a.dtype),
                       b.contiguous().view(torch.int32 if b.is_floating_point()
                                           else b.dtype))


@pytest.mark.parametrize("extra", [{}, dict(russian_roulette=True, rr_start_bounce=0,
                                            sky_background=False)],
                         ids=["default", "rr_nosky"])
def test_plain_version_is_the_bounce_body(mesh, extra):
    """shade_reference after K3 and K4 gives the bounce body's state bit for
    bit, at bounce 0 and after a sort that keeps the dead rays, and the
    slot tables give the rays' own random draws."""
    scene, camera = mesh
    cfg = RenderConfig(bounces=3, **extra)
    ds = device_scene(scene, "cpu")
    mats = material_table(scene.materials, "cpu")
    used = scene.packed.used_kinds
    state, ctx, ray_ctx = _wavefront(scene, camera)
    slot = torch.arange(state[0].count)
    before = LAUNCHES["shade"]
    for b in range(2):
        body = integrator._bounce_body(ds, mats, used, cfg, state, ray_ctx, b)
        win = winners(ds, state[0], cfg.tmin, alive=state[3])
        plain = sk.shade_reference(ds, mats, used, cfg, state, win, ctx, slot, b)
        assert _same(plain[3], body[3]) and not bool(body[3].all())
        for k, (p, q) in enumerate(zip((plain[0].origin, plain[0].direction,
                                        plain[0].time, *plain[1:3]),
                                       (body[0].origin, body[0].direction,
                                        body[0].time, *body[1:3]))):
            assert _same(p, q), k
        # Sort the next wavefront, dead rays kept at the tail.
        perm = torch.argsort((~body[3]).to(torch.int64) * 2 + (slot % 2), stable=True)
        state = (body[0].take(perm), body[1][perm], body[2][perm], body[3][perm])
        slot = slot[perm]
        ray_ctx = rng.RayCtx(*(w[perm] for w in ray_ctx))
    assert LAUNCHES["shade"] == before


def test_cpu_render_takes_the_torch_body(mesh):
    """A sorted render on the CPU launches nothing and equals the bounce
    body's engine."""
    scene, camera = mesh
    cfg = RenderConfig(width=12, height=12, spp=2, bounces=4)
    before = LAUNCHES["shade"]
    sorted_film = integrator.render(scene, camera, cfg, device="cpu")
    assert LAUNCHES["shade"] == before
    plain = integrator.render(scene, camera, RenderConfig(width=12, height=12, spp=2,
                                                          bounces=4, sort_rays=False),
                              device="cpu")
    assert torch.equal(sorted_film.accum, plain.accum)
    assert float(sorted_film.accum.sum()) > 0


def _cuda_like(requires_grad=False):
    """A stand-in tensor on a CUDA device, for the choice alone (no card)."""
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("case", ["cpu", "cuda", "cuda_table_grad",
                                  "cuda_table_grad_no_grad_mode", "cuda_state_grad"])
def test_kernel_takes_a_bounce_only_without_a_graph(case):
    rays = types.SimpleNamespace(origin=_cuda_like(), direction=_cuda_like(),
                                 time=_cuda_like())
    state = [rays, _cuda_like(case == "cuda_state_grad"), _cuda_like(), None]
    table = _cuda_like(case.startswith("cuda_table_grad"))
    ds = types.SimpleNamespace(spheres=_cuda_like(), planes=_cuda_like(),
                               triangles=table)
    mats = types.SimpleNamespace(albedo=_cuda_like(), param=_cuda_like(),
                                 emission=_cuda_like())
    if case == "cpu":
        state[0] = types.SimpleNamespace(origin=torch.zeros((1, 3)))
    expected = case in ("cuda", "cuda_table_grad_no_grad_mode")
    if case.endswith("no_grad_mode"):
        with torch.no_grad():
            assert integrator._kernel_shades(ds, mats, state) is expected
    else:
        assert integrator._kernel_shades(ds, mats, state) is expected


def test_gradient_through_the_sorted_wavefront(mesh):
    """Vertices that require grad, under grad mode: `_trace_sorted` runs
    the torch body (nothing launches) and the radiance's vertex gradient is
    nonzero. The mirror sphere, wound outward, reflects the sky: the
    radiance moves with its normals."""
    b = SceneBuilder()
    b.metal(0, (0.9, 0.9, 0.9), 0.0)
    b.lambertian(1, (0.5, 0.5, 0.5))
    sphere = uv_sphere_mesh(0.45, (0.0, 0.0, -0.3), 12, 24)
    b.mesh(np.ascontiguousarray(sphere[:, ::-1]), 0)  # 576 triangles: a tile-BVH
    b.plane((0.0, -0.5, 0.0), (0.0, 1.0, 0.0), (3.0, 0.0, 3.0), geometry.PLANE_XZ, 1)
    scene = finalize(b.build())
    assert integrator._sorted_eligible(scene)
    verts = torch.as_tensor(scene.triangles.vertices).clone().requires_grad_(True)
    before = LAUNCHES["shade"]
    g = integrator.render_gbuffer(with_leaves(scene, {"triangles.vertices": verts}),
                                  mesh[1], threefry.key(0),
                                  RenderConfig(width=8, height=8, spp=1, bounces=3),
                                  1, device="cpu")
    g["radiance"].sum().backward()
    assert LAUNCHES["shade"] == before
    assert torch.isfinite(verts.grad).all() and float(verts.grad.abs().max()) > 0


def test_slot_ctx_gives_each_ray_its_context():
    words = threefry.split(threefry.key(9), 3)
    n = 5
    _, multi = tcam.generate_rays_multi(tcam.derive(presets.cornell_box()[1], 1.0),
                                        words, n, 1, "cpu")
    tb0, tb1 = rng.key_bases(words, "cpu")
    slot = torch.tensor([14, 0, 7, 3, 9, 10])
    got = rng.SlotCtx(None, tb0, tb1, n, n).at(slot)
    for g, w in zip(got, multi):
        assert torch.equal(g, w[slot])
    # Ray order, with key words per ray and with one pair for all rays.
    per_ray = integrator._slot_ctx(multi)
    for g, w in zip(per_ray.at(slot), multi):
        assert torch.equal(g, w[slot])
    pid = torch.arange(15, dtype=torch.int64).flip(0)
    one = integrator._slot_ctx(rng.RayCtx(pid, int(words[1, 0]), int(words[1, 1])))
    ctx = one.at(slot)
    assert torch.equal(ctx.pixel_id, pid[slot])
    assert (ctx.base0 == int(words[1, 0])).all() and (ctx.base1 == int(words[1, 1])).all()


@pytest.mark.parametrize("case", ["all", "no_lambertian", "rr_off_before_start"])
def test_flags_carry_the_sky_roulette_and_used_kinds(case):
    if case == "all":
        cfg = RenderConfig(russian_roulette=True, rr_start_bounce=2)
        assert sk.flags(cfg, None, 2) == sk.FLAG_SKY | sk.FLAG_RR | 0xFF << 8
    elif case == "no_lambertian":
        cfg = RenderConfig(sky_background=False)
        used = (geometry.METAL, geometry.COAT, np.int32(geometry.EMISSION), 11)
        assert sk.flags(cfg, used, 5) == (1 << 1 | 1 << 6 | 1 << 3) << 8
    else:
        cfg = RenderConfig(russian_roulette=True, rr_start_bounce=3)
        assert sk.flags(cfg, (0,), 2) == sk.FLAG_SKY | 1 << 8


def _launch_args(mesh):
    scene, camera = mesh
    cfg = RenderConfig()
    ds = device_scene(scene, "cpu")
    mats = material_table(scene.materials, "cpu")
    state, ctx, _ = _wavefront(scene, camera, size=8, samples=1)
    win = winners(ds, state[0], EPSILON, alive=state[3])
    slot = torch.arange(state[0].count)
    return [ds, mats, scene.packed.used_kinds, cfg, state, win, ctx, slot, 0]


def test_shade_on_cpu_runs_the_plain_version(mesh):
    args = _launch_args(mesh)
    before = LAUNCHES["shade"]
    out, plain = sk.shade(*args), sk.shade_reference(*args)
    assert LAUNCHES["shade"] == before
    assert torch.equal(out[0].origin, plain[0].origin) and torch.equal(out[2], plain[2])


def _bad_inputs(args):
    """(what is wrong, args) with one input of the wrong device, dtype, shape or
    layout each."""
    ds, mats, used, cfg, state, win, ctx, slot, b = args
    rays = state[0]
    yield "dtype", [*args[:4], (rays, state[1].double(), *state[2:]), *args[5:]]
    yield "shape", [*args[:4], (rays, state[1], state[2][:-1], state[3]), *args[5:]]
    yield "device", [*args[:4], (rays, state[1], state[2], state[3].to("meta")),
                     *args[5:]]
    yield "layout", [*args[:4], (type(rays)(rays.origin.t().contiguous().t(),
                                            rays.direction, rays.time), *state[1:]),
                     *args[5:]]
    yield "code dtype", [*args[:5], win._replace(code=win.code.long()), *args[6:]]
    yield "k4 half", [*args[:5], win._replace(c_m=None), *args[6:]]
    yield "slot dtype", [*args[:7], slot.to(torch.int32), b]
    yield "key words", [*args[:6], ctx._replace(base1=ctx.base1[:0]), slot, b]
    yield "divisor", [*args[:6], ctx._replace(n=0), slot, b]
    yield "table", [ds._replace(triangles=ds.triangles[:, :9].contiguous()), *args[1:]]
    yield "kind dtype", [ds, mats._replace(kind=mats.kind.to(torch.int32)), *args[2:]]


def test_shade_launch_checks_its_inputs(mesh):
    args = _launch_args(mesh)
    for what, bad in _bad_inputs(args):
        with pytest.raises(ValueError, match="shade input"):
            sk._launch(*bad)


def test_shade_launch_without_nvcc_raises(mesh, tmp_path, monkeypatch):
    """The kernel path never falls back: without a CUDA toolkit the build
    raises instead of shading."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    if build.shutil.which("nvcc") or build.os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    before = LAUNCHES["shade"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sk._launch(*_launch_args(mesh))
    assert LAUNCHES["shade"] == before
