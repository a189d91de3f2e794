"""The tile-BVH cache of `finalize` on a directory it cannot write: the
build is used uncached and the pack equals an uncached one (counterpart of
the reference's io/bvh_cache.py, which renders without caching there)."""

import numpy as np

from raytracingthenextweekcuda_tpu_torch.models import presets
from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

PACK_FIELDS = ("spheres", "planes", "triangles", "trih", "quadh", "bvh_bounds",
               "bvh_meta", "leaf_bounds", "leaf_tiles")


def test_unwritable_cache_dir_builds_uncached(tmp_path):
    """A cache directory under a regular file: os.makedirs raises
    (NotADirectoryError or FileExistsError, both OSErrors), which must not
    reach the caller. Holds for root too, unlike a read-only directory."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    scene, _ = presets.mesh_showcase(16, 32)
    cached = finalize(scene, use_bvh=True, bvh_cache_dir=str(blocker / "cache"))
    plain = finalize(scene, use_bvh=True)
    assert not (blocker / "cache").exists() and blocker.is_file()
    for name in PACK_FIELDS:
        np.testing.assert_array_equal(getattr(cached.packed, name),
                                      getattr(plain.packed, name), err_msg=name)
    np.testing.assert_array_equal(cached.triangles.vertices, plain.triangles.vertices)
