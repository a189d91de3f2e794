"""The configurations' scene data against the program's own presets: the
benchmark owns its scenes: the program's headline scene, and the same
scene with mesh metric 2's stand-in mesh."""

from __future__ import annotations

import numpy as np

from benchmark import program, scenedata


def _fields(part):
    import dataclasses

    return {f.name: np.asarray(getattr(part, f.name)) for f in dataclasses.fields(part)}


def _same(a, b):
    for part in ("spheres", "planes", "triangles", "materials"):
        fa, fb = _fields(getattr(a, part)), _fields(getattr(b, part))
        assert fa.keys() == fb.keys()
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), (part, k)


def _camera_same(a, b):
    import dataclasses

    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name).numpy(), getattr(b, f.name).numpy()), f.name


def test_mesh_stress_is_cornell_with_the_stand_in(tmp_path):
    """Mesh metric 2: the headline Cornell scene with a 46,816-triangle
    coat mesh, wound outward, at the upstream offset."""
    from raytracingthenextweekcuda_tpu_torch.models import presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    cfg = scenedata.load_config("mesh_stress")
    scene, camera = program.build_scene(cfg)
    box, box_cam = presets.cornell_box()
    _camera_same(camera, box_cam)
    for part in ("spheres", "planes"):
        fa, fb = _fields(getattr(scene, part)), _fields(getattr(box, part))
        assert all(np.array_equal(fa[k], fb[k]) for k in fa), part
    tris = scenedata.scene_meshes(cfg)
    assert [m for _, m in tris] == [3, 3, 20]
    ball = tris[-1][0]
    assert ball.shape[0] == cfg["published"]["triangles"] == 46816
    assert scene.triangles.count == cfg["triangles"] == 24 + 46816
    got, want = _fields(scene.triangles), _fields(box.triangles)
    assert all(np.array_equal(got[k][:24], want[k]) for k in want)
    normal = np.cross(ball[:, 1] - ball[:, 0], ball[:, 2] - ball[:, 0])
    out = ball.mean(axis=1) - np.float32([0.1, 0.0, -1.0])
    assert ((normal * out).sum(-1) > 0).all()
    assert np.allclose(np.linalg.norm(ball.reshape(-1, 3) - [0.1, 0.0, -1.0], axis=-1),
                       1.0, atol=1e-5)
    packed = finalize(scene, bvh_cache_dir=str(tmp_path)).packed
    assert packed.leaf_tiles.shape[1] == 84


def test_cornell_is_the_headline_scene(tmp_path):
    from raytracingthenextweekcuda_tpu_torch.models import presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    cfg = scenedata.load_config("cornell")
    scene, camera = program.build_scene(cfg)
    want, want_cam = presets.cornell_box()
    _same(scene, want)
    _camera_same(camera, want_cam)
    got, ref = finalize(scene).packed, finalize(want).packed
    assert got.counts == ref.counts == (2, 6, 24)
    assert got.hcounts == ref.hcounts == (0, 0, 2)
    assert cfg["triangles"] == 24


def test_box_marks_match_the_packing():
    """The meshes the data marks as boxes are the ones the program's
    packing merges into oriented boxes (the roofline's work model counts
    them as boxes)."""
    from benchmark import roofline

    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    cfg = scenedata.load_config("cornell")
    counts = roofline.primitive_counts(cfg)
    packed = finalize(program.build_scene(cfg)[0]).packed
    s, p, _ = packed.counts
    assert (counts["spheres"], counts["planes"]) == (s, p)
    assert (counts["triangles"], 0, counts["boxes"]) == packed.hcounts
