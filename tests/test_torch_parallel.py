"""Tile-sharded rendering and fitting of the port (parallel/) on CPU tiles,
against the port's single-device render and the JAX reference's sharded
render on its 8-device virtual mesh (conftest.py).

Tolerances. A sharded render draws every pixel's random numbers from its
global id, so it equals the single-device render bit for bit, on each
route: the differentiable wavefront, K1's plain version over pixel ids and
the sorted tile-BVH wavefront. Gradients sum over tiles in another order
than over the whole image: rtol 1e-5 (albedo) and 2e-5 (mesh vertices),
as the reference holds its own (tests/test_parallel.py). Port against
reference: images at 1e-4, gradients at 1e-3, the bars of the other port
tests.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.parallel.mesh import make_mesh as jmake_mesh
from raytracingthenextweekcuda_tpu.parallel.render import (
    render_pass_sharded as jrender_pass_sharded,
)
from raytracingthenextweekcuda_tpu_torch import cli
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.io.procedural import uv_sphere_mesh
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    SceneBuilder,
    finalize,
    with_leaves,
)
from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.parallel import fit as pfit
from raytracingthenextweekcuda_tpu_torch.parallel.mesh import (
    make_mesh,
    replicated,
    tile_sharding,
)
from raytracingthenextweekcuda_tpu_torch.parallel.multihost import (
    init_multihost,
    measure_scaling,
)
from raytracingthenextweekcuda_tpu_torch.parallel.render import (
    render_pass_sharded,
    render_sharded,
)
from torch_parallel_worker import fit_parts, fit_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=32, height=32, spp=4, bounces=4, spp_per_pass=4)
CPU8 = [torch.device("cpu")] * 8


def tile_bvh_mesh_scene():
    """The reference's `_tile_bvh_mesh_scene` (tests/test_parallel.py:
    122-140): a metal UV sphere of 256 triangles over a plane under a
    light, forced onto the tile-BVH (the sorted wavefront)."""
    b = SceneBuilder()
    b.lambertian(0, (0.73, 0.73, 0.73))
    b.metal(1, (0.9, 0.6, 0.2), 0.05)
    b.emission(2, (1.0, 1.0, 1.0), 3.0)
    b.plane((0, -1.05, 0), (0, 1, 0), (5, 0, 5), 2, 0)
    b.sphere((0, 4, 0), 2.0, 2)
    b.mesh(uv_sphere_mesh(0.9, (0, 0, 0), 8, 16), 1)
    camera = Camera.make(eye=(0, 0.4, 2.6), center=(0, 0, 0), fov=45.0,
                         aperture=0.0, focus_distance=2.6, time1=1.0)
    return finalize(b.build(), use_bvh=True), camera


def _scene(name):
    if name == "wavefront":
        return presets.diffuse_sphere_plane()
    if name == "k1":
        scene, camera = presets.cornell_box()
        return finalize(scene), camera
    return tile_bvh_mesh_scene()


@pytest.fixture(scope="module", params=["wavefront", "k1", "sorted"])
def single(request):
    """(route, scene, camera, key, the single-device pass)."""
    scene, camera = _scene(request.param)
    key = threefry.key(7)
    return (request.param, scene, camera, key,
            integrator.render_pass(scene, camera, key, CFG, 4, device="cpu"))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_render_bit_identical_to_single_device(single, n):
    route, scene, camera, key, ref = single
    assert integrator._sorted_eligible(scene) == (route == "sorted")
    assert (integrator._fused_eligible(scene, CFG)
            and not integrator._sorted_eligible(scene)) == (route == "k1")
    out = render_pass_sharded(scene, camera, key, CFG, 4, make_mesh(n, CPU8))
    assert out.shape == (32, 32, 3)
    assert torch.equal(out, ref)


def test_sharded_mesh_tiles_off_the_ray_block():
    """24x24 over 2 tiles: 288 rays a tile, not a multiple of K4's 128-ray
    block (the work list pads them with dead rays)."""
    scene, camera = tile_bvh_mesh_scene()
    cfg = RenderConfig(width=24, height=24, spp=2, bounces=3)
    key = threefry.key(3)
    ref = integrator.render_pass(scene, camera, key, cfg, 2, device="cpu")
    out = render_pass_sharded(scene, camera, key, cfg, 2, make_mesh(2, CPU8))
    assert (cfg.num_pixels // 2) % 128
    assert torch.equal(out, ref)


def test_sharded_render_matches_jax_reference():
    jscene, jcam = jpresets.diffuse_sphere_plane()
    jcfg = JConfig(width=32, height=32, spp=4, bounces=4, spp_per_pass=4)
    ref = np.asarray(jrender_pass_sharded(jscene, jcam, jax.random.key(7), jcfg, 4,
                                          jmake_mesh(8)))
    scene, camera = presets.diffuse_sphere_plane()
    out = render_pass_sharded(scene, camera, threefry.key(7), CFG, 4,
                              make_mesh(8, CPU8)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_render_sharded_accumulates_the_film():
    scene, camera = presets.diffuse_sphere_plane()
    cfg = dataclasses.replace(CFG, spp=4, spp_per_pass=2)
    film = render_sharded(scene, camera, cfg, make_mesh(4, CPU8))
    assert film.sample_count == cfg.spp
    straight = integrator.render(scene, camera, cfg, device="cpu")
    assert torch.equal(film.accum, straight.accum)


def test_mesh_construction():
    mesh = make_mesh(4, CPU8)
    assert mesh.size == 4 and all(d.type == "cpu" for d in mesh.devices)
    with pytest.raises(ValueError, match="8 given"):
        make_mesh(9, CPU8)
    assert [sl for _, sl in tile_sharding(mesh, 16)] == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    with pytest.raises(ValueError, match="not divisible"):
        tile_sharding(mesh, 30)
    with pytest.raises(ValueError, match="not divisible"):
        render_pass_sharded(*presets.diffuse_sphere_plane(), threefry.key(0),
                            RenderConfig(width=5, height=5, spp=1, bounces=1), 1, mesh)
    copies = replicated(mesh, torch.arange(3.0))
    assert list(copies) == [torch.device("cpu")] and torch.equal(
        copies[torch.device("cpu")], torch.arange(3.0))


# ---- gradients --------------------------------------------------------------

def _albedo_loss(render, a):
    """mean(render) of the finalized sphere-plane preset with material 0's
    red albedo set to `a`."""
    scene, camera = presets.diffuse_sphere_plane()
    rows = torch.from_numpy(np.asarray(scene.materials.albedo, np.float32))
    rows = torch.cat([torch.stack([a, rows[0, 1], rows[0, 2]])[None], rows[1:]])
    return render(with_leaves(finalize(scene), {"materials.albedo": rows}),
                  camera).mean()


def _grad(loss, x0):
    x = torch.tensor(x0, requires_grad=True)
    loss(x).backward()
    return x.grad.numpy()


def test_sharded_albedo_gradient_matches_single_device_and_jax():
    """Through the differentiable wavefront over K3's plain version
    (`fused_bounce=False`), as the reference's albedo case."""
    key = threefry.key(9)
    cfg = dataclasses.replace(CFG, fused_bounce=False)
    g1 = _grad(lambda a: _albedo_loss(
        lambda s, c: integrator.render_pass(s, c, key, cfg, 4, device="cpu"), a), 0.7)
    g8 = _grad(lambda a: _albedo_loss(
        lambda s, c: render_pass_sharded(s, c, key, cfg, 4, make_mesh(8, CPU8)), a),
        0.7)
    assert g1 != 0.0
    np.testing.assert_allclose(g8, g1, rtol=1e-5)

    jscene, jcam = jpresets.diffuse_sphere_plane()
    jscene = jfinalize(jscene)
    jcfg = JConfig(width=32, height=32, spp=4, bounces=4, spp_per_pass=4,
                   fused_bounce=False)

    def jloss(a):
        mats = jscene.materials._replace(
            albedo=jscene.materials.albedo.at[0, 0].set(a))
        return jnp.mean(jintegrator.render_pass(jscene._replace(materials=mats),
                                                jcam, jax.random.key(9), jcfg, 4))

    np.testing.assert_allclose(g8, np.asarray(jax.grad(jloss)(jnp.float32(0.7))),
                               rtol=1e-3)


def test_sharded_mesh_vertex_gradients_match_single_device():
    """Per-axis vertex scale through the sorted tile-BVH wavefront (the
    reference's tests/test_parallel.py:154-187): the pack selects, the
    recompute reads the scaled vertices."""
    scene, camera = tile_bvh_mesh_scene()
    cfg = dataclasses.replace(CFG, fused_bounce=False)
    key = threefry.key(14)
    verts0 = torch.from_numpy(np.asarray(scene.triangles.vertices, np.float32))

    def loss(render, dv):
        s = with_leaves(scene, {"triangles.vertices": verts0 * (1.0 + dv)})
        return render(s).mean()

    dv0 = np.asarray([0.01, -0.02, 0.005], np.float32)
    g1 = _grad(lambda dv: loss(lambda s: integrator.render_pass(
        s, camera, key, cfg, 2, device="cpu"), dv), dv0)
    g8 = _grad(lambda dv: loss(lambda s: render_pass_sharded(
        s, camera, key, cfg, 2, make_mesh(8, CPU8)), dv), dv0)
    assert np.abs(g1).max() > 0.0
    np.testing.assert_allclose(g8, g1, rtol=2e-5, atol=1e-8)


def test_fit_step_loss_is_the_mse_and_moves_the_parameter():
    params_to_scene, camera, cfg, target = fit_parts()
    mesh = make_mesh(4, CPU8)
    a = torch.tensor(0.3, requires_grad=True)
    key = threefry.key(4)
    loss = pfit.make_loss(params_to_scene, camera, cfg, mesh, 2)([a], target, key)
    img = integrator.render_pass(params_to_scene([a.detach()]), camera, key,
                                 dataclasses.replace(cfg, fused_bounce=False), 2,
                                 device="cpu") / 2
    np.testing.assert_allclose(float(loss.detach()), float(((img - target) ** 2).mean()),
                               rtol=1e-5)
    step = pfit.make_fit_step(params_to_scene, camera, cfg, mesh, 2, lr=0.05)
    losses = [step([a], target, threefry.key(4)) for _ in range(3)]
    assert a.grad is not None and float(a.grad) != 0.0
    assert float(a.detach()) != 0.3 and np.isfinite(losses).all()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one(tmp_path):
    """Two gloo processes, each rendering 2 of the 4 tiles, give the
    gradient and the loss of one process rendering all 4 (rtol 1e-5).
    Each rank has 120 s to finish, else the test fails."""
    grad, loss = fit_step(lambda p2s, camera, cfg: pfit.make_fit_step(
        p2s, camera, cfg, make_mesh(4, CPU8), 2))
    out = tmp_path / "rank0.npy"
    address = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, address, str(rank), str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    grad2, loss2 = np.load(out)
    assert grad != 0.0
    np.testing.assert_allclose(grad2, grad, rtol=1e-5)
    np.testing.assert_allclose(loss2, loss, rtol=1e-5)


def test_init_multihost_is_a_no_op_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    init_multihost()
    assert not torch.distributed.is_initialized()


def test_init_multihost_raises_on_a_bad_address(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="Port"):
        init_multihost("127.0.0.1:99999", 2, 1, timeout=5)
    with pytest.raises(ValueError, match="rank"):
        init_multihost("127.0.0.1:1", timeout=5)
    assert not torch.distributed.is_initialized()


def test_measure_scaling_on_cpu_tiles():
    scene, camera = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=16, height=16, spp=2, bounces=2)
    rates = measure_scaling(scene, camera, cfg, device_counts=[1, 2], spp=2,
                            verbose=False, devices=CPU8)
    assert set(rates) == {1, 2} and all(r > 0 for r in rates.values())


def test_cli_render_shards(tmp_path, capsys):
    out = tmp_path / "shards.png"
    assert cli.main(["render", "--preset", "sphere-plane", "--width", "16",
                     "--height", "16", "--spp", "2", "--bounces", "2", "--shards",
                     "4", "--device", "cpu", "--out", str(out)]) == 0
    assert "rendered on 4 shards" in capsys.readouterr().err and out.exists()


def test_sharded_render_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, camera = presets.diffuse_sphere_plane()
    mesh = make_mesh(2, [torch.device("cuda", 0)] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_pass_sharded(scene, camera, threefry.key(0), CFG, 1, mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_sharded(scene, camera, CFG, mesh)
