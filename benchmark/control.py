#!/usr/bin/env python3
"""The control of the comparison that decides `correct`.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

The control is the plain reference put in the program's place and computed
in the nearest precision below the one the configuration states: bfloat16
arithmetic with the square roots, sines, cosines, exponentials and
logarithms in float32 (the configuration states float32 with those in
float64). For each seed it judges the control's outputs for the jobs a run
of that seed judges (the same pixels, job seeds and frames, at the cell's
own sizes) exactly as a run judges the program's, and prints one JSON line
with the control's `mismatch_share` beside the cell's limit. A sound
comparison reads far above the limit here. The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import drivers, harness, judge, scenedata  # noqa: E402
from benchmark.reference import pathtracer as pt  # noqa: E402

# Frames of the preview script the control judges: the end of the first
# rest (136 samples), early in the second rest (7), the end of the second.
PREVIEW_FRAMES = (149, 170, 299)


class Setup:
    """What a run of `seed` judges, drawn as its driver draws it."""

    def __init__(self, traffic: dict, seed: int):
        rng = np.random.default_rng([seed, 1])
        w, h = traffic["width"], traffic["height"]
        if traffic["kind"] == "offline":
            self.pixels = drivers.judged_pixels(rng, w, h, traffic["judge_pixels"])
            rng.integers(0, 2**31)  # the warm-up job
            self.seeds = [int(rng.integers(0, 2**31))
                          for _ in range(traffic["judge_jobs"])]
        else:
            self.session_seed = int(rng.integers(0, 2**31))
            self.script_seed = int(rng.integers(0, 2**31))
            self.pixels = drivers.judged_pixels(rng, w, h, traffic["judge_pixels"])


def control_share(workload: str, seed: int, device, frames=PREVIEW_FRAMES,
                  traffic: dict | None = None) -> float:
    """The control's mismatch share for the jobs a run of `seed` judges."""
    manifest = harness.load_manifest()
    cell = harness.cell(manifest, workload)
    traffic = traffic or harness.load_traffic(cell["workload"]["traffic"])
    cfg = scenedata.load_config(cell["workload"]["config"])
    s = Setup(traffic, seed)
    low = pt.build_scene(cfg, scenedata.scene_meshes(cfg), device, torch.bfloat16)
    ref = pt.build_scene(cfg, scenedata.scene_meshes(cfg), device)
    off = total = 0
    if traffic["kind"] == "offline":
        jobs = [(j, None) for j in s.seeds]
    else:
        jobs = [(None, f) for f in frames]
    for job_seed, frame in jobs:
        if job_seed is not None:
            kw = dict(cfg=cfg, traffic=traffic, seed=job_seed, pixels=s.pixels,
                      device=device)
            prog, _ = judge.reference_offline(**kw, ft=torch.bfloat16,
                                              fhi=torch.float32, scene=low)
            want, _ = judge.reference_offline(**kw, scene=ref)
            mask = judge.off_mask("offline", prog, want)
        else:
            kw = dict(cfg=cfg, traffic=traffic, session_seed=s.session_seed,
                      script_seed=s.script_seed, frame=frame, pixels=s.pixels,
                      device=device)
            prog, _ = judge.reference_preview(**kw, ft=torch.bfloat16,
                                              fhi=torch.float32, scene=low)
            want, _ = judge.reference_preview(**kw, scene=ref)
            mask = judge.off_mask("preview", prog.numpy(), want)
        off += int(mask.sum())
        total += mask.numel()
    return off / max(total, 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    limit = judge.load_limits(args.workload)["mismatch_share"]
    for seed in args.seeds:
        share = control_share(args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_mismatch_share": share, "limit": limit}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
