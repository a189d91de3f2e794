"""The port's loaders (OBJ, PLY, the native C++ loaders, the YAML subset
reader, the scene-file loader) against the JAX package's on the same files,
renders of scene files against the reference, and `rtnw-torch render
--scene/--bvh` on the CPU."""

import pathlib
import struct

import numpy as np
import pytest

from raytracingthenextweekcuda_tpu.config import RenderConfig as JConfig
from raytracingthenextweekcuda_tpu.io import obj as jobj
from raytracingthenextweekcuda_tpu.io import ply as jply
from raytracingthenextweekcuda_tpu.io import yaml_scene as jyaml_scene
from raytracingthenextweekcuda_tpu.models import integrator as jintegrator
from raytracingthenextweekcuda_tpu.models.scene import finalize as jfinalize
from raytracingthenextweekcuda_tpu_torch import cli, native
from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.io import obj, ply, yaml_scene
from raytracingthenextweekcuda_tpu_torch.io.image import read_png
from raytracingthenextweekcuda_tpu_torch.io.yaml_subset import safe_load
from raytracingthenextweekcuda_tpu_torch.models import integrator
from raytracingthenextweekcuda_tpu_torch.models import scene as scene_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ROOT / "assets" / "models"
SCENES = ROOT / "scenes"

OBJ_TEXT = """# a quad, a triangle with v/vt/vn forms, negative indices
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.0
v 0.5 0.5 1.0
f 1 2 3 4
f 1/2/3 2//1 5/4
f -1 -2 -3
"""

PLY_ASCII = """ply
format ascii 1.0
comment made by hand
element vertex 5
property float x
property float y
property float z
property float confidence
element face 3
property list uchar int vertex_indices
end_header
0 0 0 0.5
2 0 0 0.5
2 2 0 0.5
0 2 0 0.5
1 1 3 0.5
3 0 1 2
3 0 2 3
4 0 1 4 3
"""

# Appended to scenes/cornellbox.yaml: the repository's 3,968-triangle
# sphere, which takes the scene to the tile-BVH (and the sorted wavefront)
# in both packages; chip_smoke.py renders the same file.
SPHERE_HI_ENTRY = """  - mesh: # the 3,968-triangle sphere
      type: 2
      model: sphere_hi.obj
      scale: [0.24, 0.24, 0.24]
      rotate: [0.0, 20.0, 0.0]
      offset: [0.2, 0.25, 0.1]
      materialId: 6
      material: {type: 1, albedo: [1.0, 1.0, 1.0], fuzz: 0.0}
"""


def _sphere_hi_scene() -> str:
    return (SCENES / "cornellbox.yaml").read_text() + SPHERE_HI_ENTRY


YAML_SNIPPETS = {
    "scalars": "i: 1\nn: -2\np: +3\nf: -2.5\ne: 1.0e-3\ns: 1e-3\nd: 1.\nh: .5\n"
               "t: true\nF: False\nw: hello world\nq: 'it''s'\nqq: \"a\\\"b # c\"\n",
    "comments": "# head\na: 1  # trailing\n\n  # indented\nb: [1, 2] # after flow\nu: a#b\n",
    "nested_mappings": "top:\n  inner:\n    deep: 3\n  other: x\nnext: 2\n",
    "sequence_of_mappings": "objects:\n  - plane: # ceiling\n      type: 1\n"
                            "  - sphere:\n      type: 0\n      radius: 0.5\n",
    "sequence_at_key_indent": "seq:\n- a: 1\n  b: 2\n- c: 3\n",
    "sequence_of_scalars": "k:\n  - 1\n  - two\n  - 3.0\n",
    "flow_sequences": "v: [0.0, 1.0, 0.0]\nw: [1, [2, 3], 'x, y']\nempty: []\n",
    "flow_mappings": "m: {type: 0, albedo: [1.0, 1.0, 1.0], name: 'a, b'}\nempty: {}\n",
    "quoted_keys": "'quoted key': 1\n\"other\": 2\nkey with spaces: 3\n",
    "flow_document": "[1, 2.5, x]\n",
}

YAML_REJECTED = {
    "anchor": "a: &x 1\n",
    "alias": "a: [1]\nb: *x\n",
    "tag": "a: !!str 1\n",
    "block_scalar": "a: |\n  text\n",
    "folded_scalar": "a: >\n  text\n",
    "documents": "a: 1\n---\nb: 2\n",
    "tab": "a:\n\tb: 1\n",
    "null": "a: null\n",
    "empty_value": "a:\nb: 1\n",
    "yes": "a: yes\n",
    "octal": "a: 010\n",
    "infinity": "a: .inf\n",
    "timestamp": "a: 2001-12-14\n",
    "unclosed_flow": "a: [1, 2\n",
    "bad_indent": "a: 1\n  b: 2\n",
}


def test_parse_and_load_obj_match_reference(tmp_path):
    """Both in-repo OBJs, and a written OBJ with a quad, v/vt/vn forms and
    negative indices loaded with scale -> rotateY -> offset: the port's
    parse and transform equal the reference's exactly."""
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    kw = dict(scale=(2.0, 1.0, 0.5), rotate=(10.0, 30.0, 5.0), offset=(1.0, -2.0, 3.0))
    for p in (MODELS / "cube" / "cube_small.obj", MODELS / "sphere_hi.obj", path):
        for a, b in zip(obj.parse_obj(str(p)), jobj.parse_obj(str(p))):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        got = obj.load_obj(str(p), **kw, prefer_native=False)
        assert np.array_equal(got, jobj.load_obj(str(p), **kw, prefer_native=False))
    assert got.shape == (4, 3, 3)  # 2 + 1 + 1 fans


def test_parse_and_load_ply_match_reference(tmp_path):
    path = tmp_path / "mesh.ply"
    path.write_text(PLY_ASCII)
    for a, b in zip(ply.parse_ply(str(path)), jply.parse_ply(str(path))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pos, _ = ply.parse_ply(str(path))
    assert np.array_equal(ply.normalize_mesh(pos, (1.0, 2.0, 3.0), 0.5),
                          jply.normalize_mesh(pos, (1.0, 2.0, 3.0), 0.5))
    for normalize in (True, False):
        got = ply.load_ply(str(path), offset=(0.5, 0.0, -1.0), normalize=normalize,
                           prefer_native=False)
        ref = jply.load_ply(str(path), offset=(0.5, 0.0, -1.0), normalize=normalize,
                            prefer_native=False)
        assert got.shape == (4, 3, 3) and np.array_equal(got, ref)
    bad = tmp_path / "bad.ply"
    bad.write_text(PLY_ASCII.replace("format ascii", "format binary_big_endian"))
    with pytest.raises(ValueError, match="only ascii"):
        ply.parse_ply(str(bad))


def _write_binary_ply(path, positions, faces):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % len(positions))
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"element face %d\n" % len(faces))
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        for p in positions:
            f.write(struct.pack("<3f", *p))
        for face in faces:
            f.write(struct.pack("<B", len(face)))
            f.write(struct.pack("<%di" % len(face), *face))


def test_native_loaders_match_python(tmp_path):
    """The native C++ loaders against the Python parsers (the reference's
    tolerance, tests/test_native_loaders.py): an OBJ with its transform, an
    ASCII PLY, the same PLY written binary little-endian, and errors."""
    if not native.loaders_available():
        pytest.skip("native loaders not built")
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    kw = dict(scale=(2.0, 1.0, 0.5), rotate=(0.0, 30.0, 0.0), offset=(1.0, -2.0, 3.0))
    for p in (path, MODELS / "cube" / "cube_small.obj"):
        nat = obj.load_obj(str(p), **kw)
        np.testing.assert_allclose(nat, obj.load_obj(str(p), **kw, prefer_native=False),
                                   rtol=1e-6, atol=1e-6)
    ascii_path = tmp_path / "mesh.ply"
    ascii_path.write_text(PLY_ASCII)
    ref = ply.load_ply(str(ascii_path), offset=(0.5, 0.0, -1.0), prefer_native=False)
    np.testing.assert_allclose(ply.load_ply(str(ascii_path), offset=(0.5, 0.0, -1.0)),
                               ref, rtol=1e-6, atol=1e-6)
    bin_path = tmp_path / "mesh_bin.ply"
    _write_binary_ply(str(bin_path), [(0, 0, 0), (2, 0, 0), (2, 2, 0), (0, 2, 0),
                                      (1, 1, 3)], [(0, 1, 2), (0, 2, 3), (0, 1, 4, 3)])
    np.testing.assert_allclose(native.load_ply_native(str(bin_path), (0.5, 0.0, -1.0)),
                               ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        native.load_obj_native(str(tmp_path / "missing.obj"))
    (tmp_path / "bad.ply").write_text("not a ply\n")
    with pytest.raises(ValueError):
        native.load_ply_native(str(tmp_path / "bad.ply"))


@pytest.mark.parametrize("name", ["cornellbox.yaml", "spheres.yaml",
                                  *YAML_SNIPPETS])
def test_yaml_subset_matches_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    text = (SCENES / name).read_text() if name.endswith(".yaml") else YAML_SNIPPETS[name]
    got = safe_load(text)
    assert got == yaml.safe_load(text)
    assert repr(got) == repr(yaml.safe_load(text))  # the same types: 1 vs 1.0


@pytest.mark.parametrize("name", list(YAML_REJECTED))
def test_yaml_subset_rejects_other_constructs(name):
    with pytest.raises(ValueError, match=r"line \d+: .* outside the scene files' "
                                         r"YAML subset"):
        safe_load(YAML_REJECTED[name])


def _same_scene(scene, camera, jscene, jcamera):
    for part in ("spheres", "planes", "triangles", "materials", "mesh_info"):
        mine, ref = getattr(scene, part), getattr(jscene, part)
        for field in ref._fields:
            a, b = np.asarray(getattr(mine, field)), np.asarray(getattr(ref, field))
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{part}.{field}"
    for field in jcamera._fields:
        a, b = getattr(camera, field).numpy(), np.asarray(getattr(jcamera, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), f"camera.{field}"


@pytest.mark.parametrize("scene1_materials", [False, True])
@pytest.mark.parametrize("name", ["cornellbox.yaml", "spheres.yaml"])
def test_load_scene_matches_reference(name, scene1_materials):
    """Planes, spheres, the 24 cube triangles (float32, bit for bit), the
    material table and the camera, with the file's materials and with the
    reference renderer's runtime slots."""
    path = str(SCENES / name)
    scene, camera = yaml_scene.load_scene(path, scene1_materials=scene1_materials)
    jscene, jcamera = jyaml_scene.load_scene(path, scene1_materials=scene1_materials)
    _same_scene(scene, camera, jscene, jcamera)
    if name == "cornellbox.yaml":
        assert (scene.planes.count, scene.spheres.count, scene.triangles.count) == (
            6, 2, 24)
        assert float(camera.focus_distance) == 2.0
        assert int(scene.materials.kind[8]) == 3 and float(scene.materials.param[8]) == 5.0


def test_load_scene_model_roots_and_skips(tmp_path):
    """A model found beside the scene file; an entry without materialId or
    material skipped with a warning; a mesh keeps its declared materialId
    (the reference renderer binds every mesh to slot 3, main.cu:781)."""
    (tmp_path / "tri.obj").write_text(OBJ_TEXT)
    text = _sphere_hi_scene().replace("sphere_hi.obj", "tri.obj") + (
        "  - sphere:\n      type: 0\n      center: [0.0, 0.0, 0.0]\n      radius: 0.1\n")
    path = tmp_path / "s.yaml"
    path.write_text(text)
    with pytest.warns(UserWarning, match="skipping sphere without materialId"):
        scene, camera = yaml_scene.load_scene(str(path))
    with pytest.warns(UserWarning):
        jscene, jcamera = jyaml_scene.load_scene(str(path))
    _same_scene(scene, camera, jscene, jcamera)
    assert scene.spheres.count == 2 and scene.triangles.count == 24 + 4
    assert np.array_equal(np.asarray(scene.triangles.material_id), [3] * 24 + [6] * 4)
    with pytest.raises(FileNotFoundError, match="cube_small.obj"):
        yaml_scene.load_scene(str(path), model_roots=[str(tmp_path / "nowhere")])


@pytest.fixture(scope="module")
def sphere_hi_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("scenes") / "sphere_hi.yaml"
    path.write_text(_sphere_hi_scene())
    return str(path)


@pytest.mark.parametrize("which", ["cornellbox", "sphere_hi"])
def test_scene_file_render_matches_reference(which, sphere_hi_yaml):
    """32x32, 2 spp, 4 bounces: Cornell (24 triangles, K1's brute force with
    two boxes) and the 3,968-triangle sphere (tile-BVH, sorted wavefront),
    the port's plain versions against the reference at rtol = atol = 1e-4."""
    path = str(SCENES / "cornellbox.yaml") if which == "cornellbox" else sphere_hi_yaml
    kw = dict(width=32, height=32, spp=2, bounces=4, spp_per_pass=2)
    scene, camera = yaml_scene.load_scene(path)
    scene = scene_mod.finalize(scene)
    jscene, jcamera = jyaml_scene.load_scene(path)
    assert (scene.packed.leaf_bounds is not None) == (which == "sphere_hi")
    ref = jintegrator.render(jfinalize(jscene), jcamera, JConfig(**kw))
    film = integrator.render(scene, camera, RenderConfig(**kw), device="cpu")
    assert float(film.accum.mean()) > 0.0
    np.testing.assert_allclose(film.accum.numpy(), np.asarray(ref.accum),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bvh", [False, True], ids=["auto", "bvh"])
def test_cli_render_scene(tmp_path, monkeypatch, bvh):
    """`render --scene cornellbox.yaml` writes a PNG through the brute-force
    pack; with `--bvh` its 24 triangles go to the tile-BVH (and the sorted
    wavefront), as the reference's code forces."""
    seen = []
    finalize = scene_mod.finalize

    def spy(scene, use_bvh=None, **kw):
        out = finalize(scene, use_bvh=use_bvh, **kw)
        seen.append(out.packed.leaf_bounds is not None)
        return out

    monkeypatch.setattr(scene_mod, "finalize", spy)
    out = tmp_path / "s.png"
    args = ["render", "--scene", str(SCENES / "cornellbox.yaml"), "--width", "8",
            "--height", "6", "--spp", "1", "--bounces", "2", "--device", "cpu",
            "--out", str(out)]
    assert cli.main(args + ["--bvh"] * bvh) == 0
    assert seen == [bvh]
    img = read_png(str(out))
    assert img.shape == (6, 8, 3) and img.max() > 0
