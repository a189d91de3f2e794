"""The port's two benchmarks on two trees of the repository, in turns.

    python3 tools/ab_bench.py BEFORE_DIR AFTER_DIR [--rounds 2] [--repeats 3]

Each tree (a checkout, or an earlier commit unpacked with `git archive`)
runs in a process of its own, from its own root, importing its own package:
`apps.bench.run_bench` (the headline: Cornell 512x512, 128 spp, 10 bounces)
and `run_mesh_bench` (the published mesh stand-in, 512x512, 32 spp, 10
bounces, passes of 16), `--repeats` times each, every call with its own
warm-up render. The trees alternate BEFORE, AFTER, AFTER, BEFORE, ... for
`--rounds` pairs. Each process then runs, after one unprofiled round, a
mesh render, a headline render, a Cornell G-buffer (512x512, 8 spp, 10
bounces) and ten `bounce_step` calls on a 512x512 Cornell wavefront under
torch.profiler, and sums each kernel's device time and launches there
(K1, K2, K0, K3 and K4, by kernel name). Prints one JSON
line a process with the host-clock `render_ms` of every call and those
sums, then one line with each tree's medians. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

CHILD = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from raytracingthenextweekcuda_tpu_torch.apps.bench import run_bench, run_mesh_bench
from raytracingthenextweekcuda_tpu_torch.apps.bench_scenes import published_mesh_scene
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import camera as cam
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk

KERNELS = {"K1": "render_kernel", "K2": "path_kernel", "K0": "bounce_kernel",
           "K3": "closest_hit_kernel", "K4": "bvh_winner_kernel"}
n = int(sys.argv[1])
head = [run_bench()["render_ms"] for _ in range(n)]
mesh = [run_mesh_bench()["render_ms"] for _ in range(n)]
mscene, mcam, _ = published_mesh_scene()
mscene = finalize(mscene)
mcfg = RenderConfig(width=512, height=512, spp=32, bounces=10, spp_per_pass=16)
cornell, ccam = presets.cornell_box()
cornell = finalize(cornell)
hcfg = RenderConfig(width=512, height=512, spp=128, bounces=10, spp_per_pass=128)
gcfg = RenderConfig(width=512, height=512, spp=8, bounces=10, spp_per_pass=8)
key = threefry.key(gcfg.seed)
rays, ctx = cam.generate_rays(cam.derive(ccam, 1.0), threefry.split(key, 1)[0],
                              512, 512, device="cuda")

def steps():
    carry = bk.planar_state(rays)
    for b in range(gcfg.bounces):
        carry = bk.bounce_step(cornell.packed, carry, rng.bounce_uniforms(
            ctx.pixel_id, ctx.base0, ctx.base1, b), b >= gcfg.rr_start_bounce, gcfg)

work = [lambda: integrator.render(mscene, mcam, mcfg, device="cuda"),
        lambda: integrator.render(cornell, ccam, hcfg, device="cuda"),
        lambda: integrator.render_gbuffer(cornell, ccam, key, gcfg, gcfg.spp,
                                          device="cuda"),
        steps]
for fn in work:
    fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for fn in work:
        fn()
    torch.cuda.synchronize()
device = {k: [0, 0.0] for k in KERNELS}
for e in prof.key_averages():
    for k, name in KERNELS.items():
        if name in e.key:
            device[k][0] += e.count
            device[k][1] += e.device_time_total / 1e3
print(json.dumps({"headline_ms": head, "mesh_ms": mesh, "device": device}))
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
    got = {label: {"headline_ms": [], "mesh_ms": [],
                   **{f"{k}_device_ms": [] for k in ("K1", "K2", "K0", "K3", "K4")}}
           for label in ("before", "after")}
    for label, tree in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(args.repeats)],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({tree}) failed:\n{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        got[label]["headline_ms"] += row["headline_ms"]
        got[label]["mesh_ms"] += row["mesh_ms"]
        for k, (_, ms) in row["device"].items():
            got[label][f"{k}_device_ms"].append(ms)
        print(json.dumps({"tree": label, "dir": str(tree), **row}), flush=True)
    print(json.dumps({label: {key: statistics.median(v) for key, v in d.items()}
                      for label, d in got.items()}), flush=True)


if __name__ == "__main__":
    main()
