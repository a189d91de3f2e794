"""The benchmark as data: every cell and metric resolves to its files by
name, added files are found without an edit, names follow the manifest's
rules, and a run that has loaded JAX or the JAX package prints no result.
"""

from __future__ import annotations

import json
import shutil
import sys
import types

import pytest

from benchmark import harness, judge, run, scenedata

MANIFEST = harness.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_manifest_keys_and_names():
    assert set(MANIFEST) == TOP_KEYS
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert harness.NAME_RE.match(n), n
    for w in MANIFEST["workloads"]:
        assert harness.NAME_RE.match(w["config"]) and harness.NAME_RE.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert harness.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        for key in c["reduced"]:
            assert harness.NAME_RE.match(key)
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = harness.cell(MANIFEST, workload)
    cfg = scenedata.load_config(cell["workload"]["config"])
    assert cfg["name"] == cell["config"]["name"]
    assert scenedata.config_path(cfg["name"]).relative_to(harness.ROOT).as_posix() \
        == cell["config"]["file"]
    for key in cell["config"]["reduced"]:
        assert key in cfg and key in cfg["published"]
    traffic = harness.load_traffic(cell["workload"]["traffic"])
    assert traffic["kind"] in ("offline", "preview")
    assert "mismatch_share" in judge.load_limits(workload)
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    moved = {m["name"] for m in cell["end_to_end"]}
    for m in cell["per_layer"]:
        assert m["moves"] in moved
        assert callable(harness.load_reader(m["name"]))


def test_additions_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a reader and a cell added as new
    files and entries in a copy of the benchmark resolve like the others."""
    root = tmp_path / "repo"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    bench = root / "benchmark"
    conf = json.loads(scenedata.config_path("cornell").read_text())
    conf["name"] = "cornell_dim"
    conf["scene"]["materials"][-1]["param"] = 2.0
    (bench / "configs" / "cornell_dim").mkdir()
    (bench / "configs" / "cornell_dim" / "config.json").write_text(json.dumps(conf))
    traffic = harness.load_traffic("offline_headline")
    traffic["spp"] = 64
    (bench / "traffic" / "offline_small.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "jobs_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace.jobs if ctx.trace else None\n")
    manifest["configs"].append(dict(MANIFEST["configs"][0], name="cornell_dim",
                                    file="benchmark/configs/cornell_dim/config.json"))
    manifest["workloads"].append({"name": "cornell_dim.small", "config": "cornell_dim",
                                  "traffic": "offline_small", "chips": 1, "why": "test"})
    manifest["end_to_end"][0]["workloads"].append("cornell_dim.small")
    manifest["per_layer"].append({"name": "jobs_traced", "unit": "jobs",
                                  "better": "higher", "source": "device_trace",
                                  "layer": "device", "moves": "paths_per_s",
                                  "workloads": ["cornell_dim.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.cell(harness.load_manifest(root), "cornell_dim.small")
    assert cell["config"]["name"] == "cornell_dim"
    assert harness.load_traffic("offline_small", bench)["spp"] == 64
    read = harness.load_reader("jobs_traced", bench)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert [m["name"] for m in cell["per_layer"]] == ["jobs_traced"]
    assert {m["name"] for m in cell["end_to_end"]} == {"paths_per_s", "setup_s"}
    # Nothing that was there changed.
    for path in harness.BENCH_DIR.rglob("*"):
        if path.is_file() and "cache" not in path.parts and "__pycache__" not in path.parts:
            copy = bench / path.relative_to(harness.BENCH_DIR)
            assert copy.read_bytes() == path.read_bytes(), path


def test_forbidden_modules_compared_by_whole_name():
    loaded = {"raytracingthenextweekcuda_tpu_torch.models": None, "numpy": None,
              "jaxtyping": None, "torch": None}
    assert harness.forbidden_loaded(loaded) == []
    loaded["raytracingthenextweekcuda_tpu.ops.rng"] = None
    loaded["jax.numpy"] = None
    assert harness.forbidden_loaded(loaded) == ["jax", "raytracingthenextweekcuda_tpu"]


def test_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.finish({"correct": True}, [("mismatch_share", 0.0, 0.1)])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    assert run.finish({"correct": True}, [("mismatch_share", 0.0, 0.1)]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.splitlines()[-1]) == {"correct": True}
    assert out.err.splitlines()[-1] == "mismatch_share 0.0 limit 0.1"


def test_run_without_a_card_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "fix_caches", lambda: None)
    rc = run.main(["--workload", "cornell.offline", "--seed", str(2**31 + 1),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
