"""The port's tile-BVH build, its cache, and the tile-BVH pack of
`finalize` against the JAX reference: all bit-equal (no tolerance; the
builders are integer bookkeeping over the same float32 vertices)."""

import numpy as np
import pytest

from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu.ops import bvh_tile as jbvh
from raytracingthenextweekcuda_tpu_torch import native
from raytracingthenextweekcuda_tpu_torch.io import bvh_cache
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import LEAF_WIDTH, finalize
from raytracingthenextweekcuda_tpu_torch.ops import bvh_tile

MESHES = {"showcase": (16, 32), "stress": (64, 128)}
PACK_FIELDS = ["spheres", "planes", "triangles", "trih", "quadh", "bvh_bounds",
               "bvh_meta", "leaf_bounds", "leaf_tiles"]


@pytest.fixture(autouse=True)
def _no_reference_cache(monkeypatch):
    # The reference caches tile-BVHs under $HOME unless told not to.
    monkeypatch.setenv("RTNW_BVH_CACHE", "")


def _vertices(mesh):
    scene, _ = tpresets.mesh_showcase(*MESHES[mesh])
    return scene.triangles.vertices


def _assert_tiles_equal(a, b):
    for f in ("bounds", "meta", "perm"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("leaf", [128, LEAF_WIDTH])
def test_median_builder_bit_equal(mesh, leaf):
    v = _vertices(mesh)
    _assert_tiles_equal(jbvh.build_tile_bvh(v, leaf), bvh_tile.build_tile_bvh(v, leaf))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("leaf", [128, LEAF_WIDTH])
def test_sah_builder_bit_equal(mesh, leaf):
    if not native.available():
        pytest.skip("native/build/lib/librtnw_native.so is not built here")
    v = _vertices(mesh)
    _assert_tiles_equal(jbvh.build_tile_bvh_sah(v, leaf),
                        bvh_tile.build_tile_bvh_sah(v, leaf))


def test_permute_rows_matches_reference():
    v = _vertices("showcase")
    tb = bvh_tile.build_tile_bvh(v, 128)
    rows = np.random.default_rng(0).normal(size=(5, v.shape[0])).astype(np.float32)
    np.testing.assert_array_equal(jbvh.permute_rows(rows, tb.perm),
                                  bvh_tile.permute_rows(rows, tb.perm))


def test_builder_falls_back_to_median_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCH", [])
    assert bvh_cache.builder_name() == "median"
    v = _vertices("showcase")
    _assert_tiles_equal(jbvh.build_tile_bvh(v, LEAF_WIDTH),
                        bvh_cache.build_or_load_tile_bvh(v, LEAF_WIDTH))
    with pytest.raises(RuntimeError, match="librtnw_native.so"):
        native.build_sah_bvh(v)


def test_cache_stores_loads_and_rebuilds(tmp_path):
    v = _vertices("showcase")
    built = bvh_cache.build_or_load_tile_bvh(v, LEAF_WIDTH, cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and bvh_cache.mesh_hash(v) in files[0].name
    _assert_tiles_equal(built, bvh_cache.build_or_load_tile_bvh(
        v, LEAF_WIDTH, cache_dir=str(tmp_path)))
    files[0].write_bytes(b"not an npz")  # an unreadable file is rebuilt
    _assert_tiles_equal(built, bvh_cache.build_or_load_tile_bvh(
        v, LEAF_WIDTH, cache_dir=str(tmp_path)))
    _assert_tiles_equal(built, bvh_cache.load_tile_bvh(str(files[0])))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_finalize_tile_pack_bit_equal(mesh):
    """Permuted triangles and material ids, and the node, leaf and Havel
    rows of the tile-BVH pack."""
    jscene, _ = jpresets.mesh_showcase(*MESHES[mesh])
    tscene, _ = tpresets.mesh_showcase(*MESHES[mesh])
    ref, out = jfinalize(jscene), finalize(tscene)
    np.testing.assert_array_equal(np.asarray(ref.triangles.vertices),
                                  out.triangles.vertices)
    np.testing.assert_array_equal(np.asarray(ref.triangles.material_id),
                                  out.triangles.material_id)
    np.testing.assert_array_equal(np.asarray(ref.triangles.mesh_id),
                                  out.triangles.mesh_id)
    for f in PACK_FIELDS:
        a, b = np.asarray(getattr(ref.packed, f)), getattr(out.packed, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tuple(ref.packed.counts) == out.packed.counts
    assert tuple(ref.packed.hcounts) == out.packed.hcounts == (0, 0, 0)
    assert tuple(ref.packed.used_kinds) == out.packed.used_kinds
    assert out.packed.boxh is None
