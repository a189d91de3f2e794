"""The benchmark's manifest, found by name: a cell's configuration,
traffic mix, metrics and their readers, and the checks on names and on
the modules a run has loaded.

`BENCHMARK.json` at the repository's root lists the cells; everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own, found by the name the manifest gives:

- `configs/<config>/config.json` (scenedata.py reads it),
- `traffic/<traffic>.json`, whose `kind` names a driver (drivers.py),
- `metrics/<metric>.py`, a reader with `read(ctx) -> float | None`,
- `limits/<workload>.json`, the limits of the numbers compared.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# Top-level module names that no run may load, compared whole.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "raytracingthenextweekcuda_tpu")


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_traffic(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


def reader_path(metric: str, bench_dir: pathlib.Path = BENCH_DIR) -> pathlib.Path:
    return bench_dir / "metrics" / f"{metric}.py"


def load_reader(metric: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The `read` function of a per-layer metric's reader."""
    path = reader_path(metric, bench_dir)
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(manifest: dict, workload: str) -> dict:
    """A cell's entries: the workload, its configuration entry, and the
    end-to-end and per-layer metrics it reports."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if workload not in work:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = work[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return {"workload": w, "config": conf, "end_to_end": e2e, "per_layer": layer}


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one no run may load."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)
