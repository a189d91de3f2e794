#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA renderer `raytracingthenextweekcuda_tpu_torch`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of `BENCHMARK.json`, on one NVIDIA GPU: it loads the
cell's configuration and traffic files by name, makes the scene from the
configuration's data, warms up on the cell's own shapes (set-up), drives
the cell's entry in a closed loop for `--seconds`, judges outputs of jobs
from the window against the plain reference (reference/pathtracer.py),
and prints one JSON line last on standard output. With `--trace 1` the
first jobs of the window run under torch.profiler and the line carries the
cell's per-layer metrics instead of its end-to-end ones.

It exits non-zero without a result when no CUDA device is present or
fewer than the cell asks for, and when a module of JAX or of the JAX
package is loaded once the window has closed. Build and kernel caches stay
in fixed directories inside the checkout (`benchmark/cache/`, and the
program's own `_build/`).
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / "cache"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def process_start() -> float:
    """Wall time at which this process started (Linux), else the time this
    module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def fix_caches() -> None:
    """Every build and kernel cache in a fixed directory of the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> float | None:
    """The card's power limit in W, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(args, device, t_start: float, chips: int = 1) -> tuple[dict, list]:
    """One run of a cell on `device` (the harness's look for a chip is the
    caller's): the result line and the numbers compared with their limits."""
    import numpy as np
    import torch

    from benchmark import drivers, harness, judge, profiling, program, scenedata

    manifest = harness.load_manifest(ROOT)
    cell = harness.cell(manifest, args.workload)
    traffic = harness.load_traffic(cell["workload"]["traffic"])
    cfg = scenedata.load_config(cell["workload"]["config"])
    limits = judge.load_limits(args.workload)
    phases = {"to_cell": time.time() - t_start}

    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    scene, camera = program.build_scene(cfg)
    scene = finalize(scene, bvh_cache_dir=str(CACHE / "bvh"))
    driver = drivers.KINDS[traffic["kind"]](scene, camera, traffic, args.seed, device)
    phases["scene"] = time.time() - t_start
    driver.warmup()
    sync(device)
    # What set-up made stays: a full collection in the window then walks
    # only what the window makes, not every module and tensor of set-up.
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start
    phases["warmup"] = setup_s

    trace = None
    t0 = time.perf_counter()
    if args.trace:
        for _ in range(3):  # a trace that holds no device record is taken again
            trace = profiling.capture(driver.job, traffic["trace_jobs"], driver.keep)
            if trace.device or device.type != "cuda":
                break
            print("[bench] the trace holds no device record; tracing again",
                  file=sys.stderr, flush=True)
    while time.perf_counter() - t0 < args.seconds:
        driver.job()
        driver.keep()
    window_s = time.perf_counter() - t0
    e2e = driver.end_to_end(window_s)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    records = driver.records()
    driver.release()
    del scene
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    res = judge.judge(traffic["kind"], cfg, traffic, driver, records, device)
    reference_s = time.perf_counter() - t_ref
    limit = limits["mismatch_share"]
    checks = [("mismatch_share", res["mismatch_share"], limit)]
    correct = all(v <= lim for _, v, lim in checks)

    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    metrics = {}
    if args.trace:
        ctx = types.SimpleNamespace(kind=traffic["kind"], trace=trace, traffic=traffic,
                                    config=cfg, path_bounces=res["path_bounces"],
                                    judged_pixels=res["judged_pixels"])
        for m in cell["per_layer"]:
            value = harness.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for name, value in e2e.items():
            if name in units:
                metrics[name] = {"value": float(value), "unit": units[name]}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
                "count": chips, "memory_peak_bytes": int(peak)}
    if args.trace and trace is not None:
        dev_info["busy_s"] = trace.busy_s
        dev_info["window_s"] = trace.window_s
    if device.type == "cuda":
        dev_info["power_limit_w"] = power_limit()
    line = {"correct": bool(correct), "attempted": driver.jobs,
            "failed": sum(1 for _, share in res["per_job"] if share > limit),
            "metrics": metrics, "device": dev_info}
    if args.trace and trace is not None:
        line["breakdown"] = {"device_ops": trace.device_ops(),
                             "idle_gaps": trace.idle_gaps()}
    ms = np.asarray(driver.times) * 1e3
    fifth = max(1, len(ms) // 5)
    line["judged"] = {"jobs": [j for j, _ in res["per_job"]],
                      "job_ms": {"quartiles": [float(x) for x in
                                               np.percentile(ms, [0, 25, 50, 75, 100])],
                                 "first_fifth": float(ms[:fifth].mean()),
                                 "last_fifth": float(ms[-fifth:].mean())},
                      "pixels_per_job": res["judged_pixels"],
                      "window_s": window_s, "reference_s": reference_s,
                      "setup_phases_s": phases}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line, checks


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    fix_caches()
    from benchmark import harness

    chips = {w["name"]: w for w in harness.load_manifest(ROOT)["workloads"]
             }[args.workload]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    line, checks = run_cell(args, torch.device("cuda:0"), t_start, chips)
    return finish(line, checks)


def finish(line: dict, checks: list) -> int:
    """Print the numbers compared and the result line, unless a module of
    JAX or of the JAX package was loaded: then print no result and fail."""
    from benchmark import harness

    bad = harness.forbidden_loaded()
    if bad:
        print(f"[bench] forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
