"""The port's scene builder, presets and host packers give the JAX
reference's packed rows bit for bit."""

import numpy as np
import pytest

from raytracingthenextweekcuda_tpu.io.procedural import cube_mesh
from raytracingthenextweekcuda_tpu.models import presets as jpresets
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu_torch.models import presets as tpresets
from raytracingthenextweekcuda_tpu_torch.models.scene import (
    finalize,
    from_jax_arrays,
)
from raytracingthenextweekcuda_tpu_torch.ops.cuda.bounce_kernel import (
    _merge_parallelograms,
)

PRESETS = ["diffuse_sphere_plane", "cornell_box", "defocus_blur",
           "smallpt_spheres", "mesh_showcase"]
ROWS = ["spheres", "planes", "triangles", "trih", "quadh", "boxh"]


@pytest.fixture(scope="module")
def jax_scenes():
    return {p: getattr(jpresets, p)() for p in PRESETS}


def _assert_packs_equal(ref, out):
    for name in ROWS:
        a, b = getattr(ref, name), getattr(out, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert tuple(ref.counts) == tuple(out.counts)
    assert tuple(ref.hcounts) == tuple(out.hcounts)
    assert tuple(ref.used_kinds) == tuple(out.used_kinds)
    assert ref.has_emission == out.has_emission
    assert out.shaded


@pytest.mark.parametrize("preset", PRESETS)
def test_packed_rows_bit_equal(preset, jax_scenes):
    jscene, _ = jax_scenes[preset]
    tscene, _ = getattr(tpresets, preset)()
    _assert_packs_equal(jfinalize(jscene, use_bvh=False).packed,
                        finalize(tscene, use_bvh=False).packed)


@pytest.mark.parametrize("preset", PRESETS)
def test_from_jax_arrays_packs_the_same(preset, jax_scenes):
    jscene, _ = jax_scenes[preset]
    arrays = {f"{part}.{field}": np.asarray(getattr(getattr(jscene, part), field))
              for part in ("spheres", "planes", "triangles", "materials",
                           "mesh_info")
              for field in getattr(jscene, part)._fields}
    _assert_packs_equal(jfinalize(jscene, use_bvh=False).packed,
                        finalize(from_jax_arrays(arrays), use_bvh=False).packed)


def test_cornell_packs_as_two_boxes():
    scene, _ = tpresets.cornell_box()
    assert scene.triangles.count == 24
    packed = finalize(scene).packed  # auto: 24 < 256 triangles, brute force
    assert packed.hcounts == (0, 0, 2)
    assert packed.counts == (2, 6, 24)


def test_tile_bvh_scenes_raise():
    scene, _ = tpresets.mesh_showcase()
    assert scene.triangles.count > 256
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        finalize(scene)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        finalize(tpresets.cornell_box()[0], use_bvh=True)


_CUBE = np.asarray(cube_mesh(0.5, (0.0, 0.0, 0.0)), np.float32)
_SKEW = np.asarray([[[5.0, 0.0, 0.0], [6.0, 0.0, 0.0], [5.0, 1.3, 0.7]]],
                   np.float32)


@pytest.mark.parametrize("tris,mats,quads,rest", [
    # A cube's 12 triangles merge into exactly 6 parallelogram quads.
    (_CUBE, np.zeros((12,), np.int32), 6, 0),
    # A skewed extra triangle stays a triangle.
    (np.concatenate([_CUBE, _SKEW]), np.zeros((13,), np.int32), 6, 1),
    # Different materials across a shared edge block merging.
    (_CUBE, np.arange(12, dtype=np.int32), 0, 12),
], ids=["cube", "cube_plus_skew", "distinct_materials"])
def test_merge_parallelograms(tris, mats, quads, rest):
    qv0, _, _, _, left = _merge_parallelograms(tris, mats)
    assert qv0.shape[0] == quads and left.shape[0] == rest
