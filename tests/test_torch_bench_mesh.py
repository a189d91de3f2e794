"""Mesh metrics 2 and 3 of the port's benchmarks (apps/bench.py) and K4's
leaf counters (`stats`), against the JAX reference on the CPU.

The reference's probe runs once, its kernels in interpret mode, on a
tile-BVH UV sphere of 8 leaves at 32x32; its K4 calls are recorded. The
port's plain K4 gets the same rays, ceilings and alive flags and must give
the same counters exactly (they are integer bookkeeping over the same
slab arithmetic). The port's probe must give the reference's numbers
exactly at bounce 0 and within 2% later: from the second bounce on the
reference sorts with an unstable sort, so rays of equal keys may fill the
128-ray blocks in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingthenextweekcuda_tpu.apps import bench as jbench
from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops.pallas import bvh_winner_kernel as jk4
from raytracingthenextweekcuda_tpu.ops.pallas import intersect_kernel as jk3
from raytracingthenextweekcuda_tpu_torch import cli
from raytracingthenextweekcuda_tpu_torch.apps import bench, bench_scenes
from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays

PROBE_CFG = dict(width=32, height=32, spp=1, bounces=10)
MESH = (32, 64)  # mesh_showcase(n_lat, n_lon): 4,032 triangles, 8 leaves


@pytest.fixture(scope="module")
def reference():
    """(reference scene, its probe's output, its K4 calls: rays, alive,
    t_cap, list lengths and counters of each bounce)."""
    calls = []
    k3_run, k4_run = jk3.intersect_packed, jk4.intersect_packed_bvh

    def k3_interpret(rays, packed, tmin=EPSILON, backface_cull=True,
                     interpret=False, **kw):
        return k3_run(rays, packed, tmin, backface_cull, True, **kw)

    def k4_recorded(rays, packed, tmin=EPSILON, backface_cull=True,
                    interpret=False, **kw):
        out = k4_run(rays, packed, tmin, backface_cull, True, **kw)
        if not kw.get("stats"):  # the bounce body's own intersection
            return out
        calls.append({"origin": np.asarray(rays.origin),
                      "direction": np.asarray(rays.direction),
                      "time": np.asarray(rays.time),
                      "alive": np.asarray(kw["alive"]),
                      "t_cap": np.asarray(kw["t_cap"]),
                      "counts": np.asarray(out[2][0]),
                      "stats": np.asarray(out[2][1])})
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTNW_BVH_CACHE", "")
        mp.setattr(jk3, "intersect_packed", k3_interpret)
        mp.setattr(jk4, "intersect_packed_bvh", k4_recorded)
        jscene, jcam = jpresets.mesh_showcase(*MESH)
        jscene = jfinalize(jscene, use_bvh=True)
        probe = jbench._winner_stats_probe(jscene, jcam, JConfig(**PROBE_CFG))
    return jscene, probe, calls


@pytest.fixture(scope="module")
def port_scene():
    scene, camera = presets.mesh_showcase(*MESH)
    return finalize(scene, use_bvh=True), camera


def _rays(call) -> Rays:
    return Rays(*(torch.from_numpy(call[k].copy())
                  for k in ("origin", "direction", "time")))


@pytest.mark.parametrize("bounce", [0, 2], ids=["primary", "bounce2"])
def test_k4_stats_match_reference(reference, port_scene, bounce):
    """The plain K4's list lengths and [walked, evaluated] on the reference's
    wavefront, as the reference's probe ran it: the same, block for block."""
    _, _, calls = reference
    call = calls[bounce]
    leaves = device_scene(port_scene[0], "cpu").leaves
    assert leaves.n_leaves == 8
    _, _, (counts, st) = k4.intersect_packed_bvh(
        _rays(call), leaves, EPSILON, alive=torch.from_numpy(call["alive"].copy()),
        t_cap=torch.from_numpy(call["t_cap"].copy()), stats=True)
    n_blocks = counts.shape[0]
    # The reference pads to 4 blocks of 128 rays; its extra blocks are dead.
    np.testing.assert_array_equal(counts.numpy(), call["counts"][:n_blocks])
    np.testing.assert_array_equal(st.numpy(), call["stats"][:n_blocks])
    assert not call["stats"][n_blocks:].any() and st.sum() > 0


@pytest.mark.parametrize("bounce", [0, 2], ids=["primary", "bounce2"])
def test_k4_stats_count_stops_and_skips(reference, port_scene, bounce):
    """On lists built without the ceilings that the walk then gets (every
    ray capped at the median entry of its block's list), a block stops at
    its horizon before the end of its list (walked < listed) or walks past
    leaves that no ray needs any more (evaluated < walked); evaluated <=
    walked <= listed always."""
    call = reference[2][bounce]
    leaves = device_scene(port_scene[0], "cpu").leaves
    origin, direction, alive, _, _ = k4.winner_inputs(
        _rays(call), leaves, EPSILON, torch.from_numpy(call["alive"].copy()))
    wl = k4.build_worklist(origin, direction, alive, leaves.leaf_bounds, EPSILON)
    median = torch.nanmedian(torch.where(wl.entry.isfinite(), wl.entry, np.nan), dim=1)
    cap = torch.minimum(torch.from_numpy(call["t_cap"].copy()),
                        median.values.repeat_interleave(k4.BLOCK))
    _, _, st = k4.winner_reference(origin, direction, alive, cap, wl, leaves,
                                   EPSILON, stats=True)
    assert ((st[:, 1] <= st[:, 0]) & (st[:, 0] <= wl.counts)).all()
    assert (st[:, 0] < wl.counts).any() or (st[:, 1] < st[:, 0]).any()


def test_k4_stats_leave_the_winners_alone(reference, port_scene):
    leaves = device_scene(port_scene[0], "cpu").leaves
    call = reference[2][1]
    rays = _rays(call)
    kw = dict(alive=torch.from_numpy(call["alive"].copy()),
              t_cap=torch.from_numpy(call["t_cap"].copy()))
    t, code = k4.intersect_packed_bvh(rays, leaves, EPSILON, **kw)
    t_s, code_s, _ = k4.intersect_packed_bvh(rays, leaves, EPSILON, stats=True, **kw)
    assert torch.equal(t, t_s) and torch.equal(code, code_s)


def test_stats_probe_matches_reference(reference, port_scene):
    _, ref, _ = reference
    scene, camera = port_scene
    out = bench._winner_stats_probe(scene, camera, RenderConfig(**PROBE_CFG),
                                    device="cpu")
    assert list(out) == list(ref) == ["bounce0", "bounce1", "bounce2"]
    assert out["bounce0"] == ref["bounce0"]
    for b in ("bounce1", "bounce2"):
        for field, value in ref[b].items():
            np.testing.assert_allclose(out[b][field], value, rtol=0.02,
                                       err_msg=f"{b} {field}")


def test_large_mesh_scene_is_the_reference_stand_in():
    scene, _, asset = bench_scenes.large_mesh_scene()
    assert scene.triangles.count == 2 * 256 * 512 - 2 * 512
    assert "stand-in" in asset and "12x materialball" in asset


MESH_KEYS = {"metric", "paths_per_sec", "render_ms", "triangles", "leaves", "asset",
             "config", "device", "card"}


@pytest.fixture
def cpu_bench(monkeypatch):
    """The benches on the CPU: their CUDA check let through, for a test."""
    monkeypatch.setattr(bench, "_cuda_device", torch.device)


def test_mesh_benches_report_their_keys(cpu_bench):
    small = dict(width=16, height=16, spp=2, bounces=2, spp_per_pass=2,
                 device="cpu")
    one = bench.run_mesh_bench(**small)
    assert set(one) == MESH_KEYS and one["triangles"] == 960 and one["leaves"] == 2
    stress = bench.run_mesh_stress(**small)
    assert set(stress) == MESH_KEYS | {"leaf_tile", "stats"}
    assert stress["triangles"] == 16128 and stress["leaf_tile"] == 768
    assert list(stress["stats"]) == ["bounce0", "bounce1", "bounce2"]
    assert set(stress["stats"]["bounce0"]) == {"listed", "walked", "evaluated",
                                               "live_blocks"}
    large = bench.run_mesh_large(width=8, height=8, spp=1, bounces=1,
                                 spp_per_pass=1, device="cpu")
    assert set(large) == MESH_KEYS | {"frustum", "vs_baseline"}
    assert large["triangles"] == 261120 and large["leaves"] == 496
    assert large["frustum"] is False and large["vs_baseline"] is None
    assert all(r["paths_per_sec"] > 0 and r["device"] == "cpu"
               for r in (one, stress, large))


@pytest.mark.parametrize("flag", ["--mesh-stress", "--mesh-large"])
def test_mesh_bench_cli_needs_cuda(flag, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", flag, "--width", "8", "--height", "8", "--spp", "1"])
