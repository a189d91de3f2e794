"""The port's two benchmarks and its kernels on two trees of the repository,
in turns.

    python3 tools/ab_bench.py BEFORE_DIR AFTER_DIR [--rounds 2] [--repeats 3]

Each tree (a checkout, or an earlier commit unpacked with `git archive`)
runs in a process of its own, from its own root, importing its own package:
`apps.bench.run_bench` (the headline: Cornell 512x512, 128 spp, 10 bounces)
and `run_mesh_bench` (the published mesh stand-in, 512x512, 32 spp, 10
bounces, passes of 16), `--repeats` times each, every call with its own
warm-up render, and as many renders of the mesh benchmark's configuration
on the forced megastep route (`_sorted_eligible` made false, K1 with the
tile-BVH walk). The trees alternate BEFORE, AFTER, AFTER, BEFORE, ... for
`--rounds` pairs. Each process then runs, after one unprofiled run, each of
these under torch.profiler and sums each kernel's device time and launches
there (K1, K2, K0, K3 and K4 by kernel name, the instantiations with the
tile-BVH walk apart as K1-BVH, K2-BVH and K0-BVH; `all`, every kernel of
the workload, torch's included): a mesh render, a
headline render, a Cornell G-buffer (512x512, 8 spp, 10 bounces), ten
`bounce_step` calls on a 512x512 Cornell wavefront, a forced mesh render,
one forced 16-spp pass of the stress stand-in (32 leaves), a forced
G-buffer of the published stand-in (512x512, 2 spp, 10 bounces) and ten
`bounce_step` calls on its 512x512 wavefront. The ten Cornell
`bounce_step` calls are also timed on the host clock (`steps_ms`). Prints
one JSON line a process with the host-clock `render_ms` of every call and
those sums, then one line with each tree's medians. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

CHILD = """
import json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from raytracingthenextweekcuda_tpu_torch.apps.bench import run_bench, run_mesh_bench
from raytracingthenextweekcuda_tpu_torch.apps.bench_scenes import (
    published_mesh_scene, stress_mesh_scene)
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as cam
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk

KERNELS = {"K1": "render_kernel", "K2": "path_kernel", "K0": "bounce_kernel",
           "K3": "closest_hit_kernel", "K4": "bvh_winner_kernel"}
n = int(sys.argv[1])
mscene, mcam, _ = published_mesh_scene()
mscene = finalize(mscene)
sscene, scam, _ = stress_mesh_scene()
sscene = finalize(sscene)
mcfg = RenderConfig(width=512, height=512, spp=32, bounces=10, spp_per_pass=16)
pass_cfg = RenderConfig(width=512, height=512, spp=16, bounces=10, spp_per_pass=16)
cornell, ccam = presets.cornell_box()
cornell = finalize(cornell)
hcfg = RenderConfig(width=512, height=512, spp=128, bounces=10, spp_per_pass=128)
gcfg = RenderConfig(width=512, height=512, spp=8, bounces=10, spp_per_pass=8)
mgcfg = RenderConfig(width=512, height=512, spp=2, bounces=10, spp_per_pass=2)
key = threefry.key(gcfg.seed)
sorted_eligible = integrator._sorted_eligible


def forced(fn):
    integrator._sorted_eligible = lambda *_: False
    try:
        return fn()
    finally:
        integrator._sorted_eligible = sorted_eligible


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def steps(scene, camera):
    rays, ctx = cam.generate_rays(cam.derive(camera, 1.0), threefry.split(key, 1)[0],
                                  512, 512, device="cuda")

    def run():
        carry = bk.planar_state(rays)
        for b in range(gcfg.bounces):
            carry = bk.bounce_step(scene.packed, carry, rng.bounce_uniforms(
                ctx.pixel_id, ctx.base0, ctx.base1, b), b >= gcfg.rr_start_bounce,
                gcfg)
    return run


head = [run_bench()["render_ms"] for _ in range(n)]
mesh = [run_mesh_bench()["render_ms"] for _ in range(n)]
render_forced = lambda: forced(lambda: integrator.render(mscene, mcam, mcfg,
                                                         device="cuda"))
render_forced()
forced_ms = [host_ms(render_forced) for _ in range(n)]
cornell_steps = steps(cornell, ccam)
cornell_steps()
steps_ms = [host_ms(cornell_steps) for _ in range(n)]
work = {
    "mesh": lambda: integrator.render(mscene, mcam, mcfg, device="cuda"),
    "headline": lambda: integrator.render(cornell, ccam, hcfg, device="cuda"),
    "gbuffer": lambda: integrator.render_gbuffer(cornell, ccam, key, gcfg, gcfg.spp,
                                                 device="cuda"),
    "steps": cornell_steps,
    "forced_mesh": render_forced,
    "forced_stress_pass": lambda: forced(lambda: integrator.render(
        sscene, scam, pass_cfg, device="cuda")),
    "forced_gbuffer": lambda: forced(lambda: integrator.render_gbuffer(
        mscene, mcam, key, mgcfg, mgcfg.spp, device="cuda")),
    "mesh_steps": steps(mscene, mcam),
}
device = {}
for name, fn in work.items():
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    sums = {"all": [0, 0.0]}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            sums["all"][0] += e.count
            sums["all"][1] += e.device_time_total / 1e3
        for k, kname in KERNELS.items():
            if kname in e.key:
                label = k + ("-BVH" if "<true>" in e.key else "")
                got = sums.setdefault(label, [0, 0.0])
                got[0] += e.count
                got[1] += e.device_time_total / 1e3
    device[name] = sums
print(json.dumps({"headline_ms": head, "mesh_ms": mesh, "forced_ms": forced_ms,
                  "steps_ms": steps_ms, "device": device}))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("before", type=pathlib.Path)
    ap.add_argument("after", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    pair = [("before", args.before), ("after", args.after)]
    order = ((pair + pair[::-1]) * args.rounds)[: 2 * args.rounds]
    got = {label: {} for label in ("before", "after")}
    for label, tree in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(args.repeats)],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({tree}) failed:\n{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        for key in ("headline_ms", "mesh_ms", "forced_ms", "steps_ms"):
            got[label].setdefault(key, []).extend(row[key])
        for work, sums in row["device"].items():
            for kernel, (_, ms) in sums.items():
                got[label].setdefault(f"{work}/{kernel}_device_ms", []).append(ms)
        print(json.dumps({"tree": label, "dir": str(tree), **row}), flush=True)
    print(json.dumps({label: {key: statistics.median(v) for key, v in d.items()}
                      for label, d in got.items()}), flush=True)


if __name__ == "__main__":
    main()
