"""The port does everything the JAX package does: every public top-level
function and class of every module of `raytracingthenextweekcuda_tpu/`,
and every public method of its classes, has a counterpart of the same name
at the mapped path of `raytracingthenextweekcuda_tpu_torch/`
(`ops/pallas/X.py` maps to `ops/cuda/X.py`), a counterpart under another
name (`PORTED_AS`), or an entry in `NOT_PORTED` with its reason.

Both tables fail when stale: an entry whose name the reference no longer
has, a `NOT_PORTED` name that the port now has, or a `PORTED_AS` target
the port does not have. `ROADMAP.md` §1's "Not ported, by design" list
names every `NOT_PORTED` entry. The test reads the sources' syntax trees
and imports neither package.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "raytracingthenextweekcuda_tpu"
PORT = ROOT / "raytracingthenextweekcuda_tpu_torch"

# "module:name" of the reference -> why the port has no counterpart.
NOT_PORTED = {
    "ops/sampling.py:uniform": "key-based sampler with no caller; the port draws from pcg4d",
    "ops/sampling.py:in_unit_disk": "key-based sampler with no caller",
    "ops/sampling.py:unit_vector": "key-based sampler with no caller",
    "ops/sampling.py:in_unit_sphere": "key-based sampler with no caller",
    "ops/sampling.py:hemisphere": "key-based sampler with no caller",
    "ops/sampling.py:cosine_hemisphere": "key-based sampler with no caller; "
                                         "cosine_hemisphere_from_uniforms is ported",
    "ops/sampling.py:phong_lobe": "key-based sampler with no caller; "
                                  "phong_lobe_from_uniforms is ported",
    "ops/wavefront_sort.py:sort_wavefront": "only tests call it; the port sorts "
                                            "with argsort and gathers",
    "apps/bench_scenes.py:reference_assets_present": "the reference's resource "
                                                     "directory lies outside the "
                                                     "repository; the port renders "
                                                     "the stand-ins",
    "ops/pallas/intersect_kernel.py:PackedScene.tree_flatten": "JAX pytree protocol",
    "ops/pallas/intersect_kernel.py:PackedScene.tree_unflatten": "JAX pytree protocol",
    "cli.py:_apply_platform": "selects a JAX platform; the port takes --device",
    "io/bvh_cache.py:_tile_cache_dir": "reads RTNW_BVH_CACHE; the port takes "
                                       "finalize's bvh_cache_dir argument",
}

# "module:name" of the reference -> "module:name" of its port.
PORTED_AS = {
    "apps/bench.py:_vpu_utilization": "apps/bench.py:fp32_utilization",
    "ops/pallas/intersect_kernel.py:pack_scene": "ops/cuda/intersect_kernel.py:pack_scene_host",
    "ops/geometry.py:Materials.gather": "ops/materials.py:gather",
    "ops/geometry.py:Spheres.center_at": "ops/intersect.py:intersect_spheres",
}


def _port_path(module: str) -> str:
    parts = module.split("/")
    if parts[:2] == ["ops", "pallas"]:
        parts[1] = "cuda"
    return "/".join(parts)


def _names(path: pathlib.Path) -> set:
    """Top-level functions and classes, and each class's methods as
    `Class.method`."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return names


def _public(name: str) -> bool:
    return not any(part.startswith("_") for part in name.split("."))


def _has(module: str, name: str, root: pathlib.Path) -> bool:
    path = root / module
    return path.exists() and name in _names(path)


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = PORT / _port_path(module)
    assert port.exists(), f"{module} has no counterpart {_port_path(module)}"
    ported = _names(port)
    missing = sorted(
        name for name in _names(REF / module)
        if _public(name) and name not in ported
        and f"{module}:{name}" not in NOT_PORTED and f"{module}:{name}" not in PORTED_AS
    )
    assert not missing, f"{module}: no counterpart and no NOT_PORTED reason for {missing}"


@pytest.mark.parametrize("entry", sorted(NOT_PORTED))
def test_not_ported_entries_are_not_stale(entry):
    module, name = entry.split(":")
    assert NOT_PORTED[entry].strip()
    assert _has(module, name, REF), f"the reference no longer has {entry}"
    assert not _has(_port_path(module), name, PORT), f"the port now has {entry}"


@pytest.mark.parametrize("entry", sorted(PORTED_AS))
def test_ported_as_entries_are_not_stale(entry):
    module, name = entry.split(":")
    assert _has(module, name, REF), f"the reference no longer has {entry}"
    assert not _has(_port_path(module), name, PORT), f"the port has {entry} itself"
    assert _has(*PORTED_AS[entry].split(":"), PORT), f"the port has no {PORTED_AS[entry]}"


def test_vpu_utilization_is_ported_as_fp32_utilization():
    assert PORTED_AS["apps/bench.py:_vpu_utilization"] == "apps/bench.py:fp32_utilization"
    assert _has("apps/bench.py", "_vpu_utilization", REF)
    assert _has("apps/bench.py", "fp32_utilization", PORT)


def test_roadmap_names_every_not_ported_entry():
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Not ported, by design.**")
    section = text[start:text.index("\n### ", start)]
    unnamed = [e for e in NOT_PORTED if f"`{e}`" not in section]
    assert not unnamed, f"ROADMAP.md's Not ported list does not name {unnamed}"
