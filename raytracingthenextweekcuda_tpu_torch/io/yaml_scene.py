"""YAML scene loader of the port (counterpart of
raytracingthenextweekcuda_tpu/io/yaml_scene.py), reference-schema
compatible: resources/scenes/*.yaml files load verbatim (SCENE 1 branch,
main.cu:623-786):

    camera: {eye, center, up, aperture, fov}
    objects:
      - sphere: {type: 0, center, radius, materialId, material: {...}}
      - plane:  {type: 1, orientation, position, normal, extend, materialId,
                 twoSide, material: {...}}
      - mesh:   {type: 2, model, scale, rotate, offset, materialId,
                 material: {...}}

Material `type`: 0 Lambertian{albedo} / 1 Metal{albedo, fuzz} /
2 Dieletric{indexOfRefraction} / 3 Emission{albedo, intensity}
(MaterialType enum order, Material.h:8-13; parse at main.cu:710-747).
First definition of a materialId wins (create-if-null semantics).

The file is read by io/yaml_subset.py, not PyYAML. Mesh models are looked
up under `model_roots`: by default `assets/models` under the working
directory and under the repository, then the scene file's directory (the
reference's $RTNW_MODEL_ROOTS is not read).

Divergence noted, as in the reference: the reference CUDA renderer binds
every YAML mesh to materials[3] regardless of its materialId (main.cu:781,
an apparent bug); the declared materialId is honoured, which is identical
for the shipped scenes.
"""

from __future__ import annotations

import os
import warnings

from raytracingthenextweekcuda_tpu_torch.io.obj import load_obj
from raytracingthenextweekcuda_tpu_torch.io.ply import load_ply
from raytracingthenextweekcuda_tpu_torch.io.yaml_subset import safe_load
from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
from raytracingthenextweekcuda_tpu_torch.models.scene import Scene, SceneBuilder

# MaterialType enum order (Material.h:8-13).
_MAT_LAMBERTIAN, _MAT_METAL, _MAT_DIELECTRIC, _MAT_EMISSION = 0, 1, 2, 3

DEFAULT_MODEL_ROOTS = [
    "assets/models",
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "models"),
]


def _resolve_model(path: str, model_roots) -> str:
    for root in model_roots:
        candidate = os.path.join(root, path)
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(f"model '{path}' not found under any of {list(model_roots)}")


def _register_material(builder: SceneBuilder, material_id: int, spec: dict) -> None:
    mtype = int(spec["type"])
    if mtype == _MAT_LAMBERTIAN:
        builder.lambertian(material_id, tuple(spec["albedo"]))
    elif mtype == _MAT_METAL:
        builder.metal(material_id, tuple(spec["albedo"]), float(spec.get("fuzz", 1.0)))
    elif mtype == _MAT_DIELECTRIC:
        builder.dielectric(material_id, float(spec["indexOfRefraction"]))
    elif mtype == _MAT_EMISSION:
        builder.emission(material_id, tuple(spec["albedo"]),
                         float(spec.get("intensity", 1.0)))
    else:
        raise ValueError(f"unknown material type {mtype}")


def register_scene1_materials(builder: SceneBuilder) -> None:
    """Pre-register the reference's 9 hard-coded material slots.

    initialize() creates materials 0-8 BEFORE parsing the YAML
    (main.cu:643-651), and the parser's create-if-null check
    (main.cu:710-747) then ignores every inline material definition whose
    slot is taken, so at runtime cornellbox2's "light" plane (declared
    Lambertian in the file) is Emission((1,1,1), 5.0) from slot 8. Calling
    this before the load gives the builder those runtime materials; first
    definition wins makes the file's inline definitions inert.
    """
    builder.lambertian(0, (1.0, 0.0, 0.0))
    builder.lambertian(1, (0.0, 1.0, 0.0))
    builder.lambertian(2, (0.0, 0.0, 1.0))
    builder.lambertian(3, (1.0, 1.0, 1.0))
    builder.lambertian(4, (0.75, 0.25, 0.25))
    builder.lambertian(5, (0.25, 0.25, 0.75))
    builder.metal(6, (1.0, 1.0, 1.0), 0.0)
    builder.dielectric(7, 1.5)
    builder.emission(8, (1.0, 1.0, 1.0), 5.0)


def load_scene(path: str, model_roots=None, scene1_materials: bool = False
               ) -> tuple[Scene, Camera]:
    """Load a reference-format YAML scene file -> (Scene, Camera), unpacked
    (call models.scene.finalize on it).

    scene1_materials=True reproduces the reference's runtime material
    binding (pre-created slots 0-8 override the file's inline definitions;
    see register_scene1_materials) instead of the file's declarations.
    """
    builder, camera = load_scene_builder(path, model_roots,
                                         scene1_materials=scene1_materials)
    return builder.build(), camera


def load_scene_builder(path: str, model_roots=None, scene1_materials: bool = False
                       ) -> tuple[SceneBuilder, Camera]:
    """Like load_scene, but returns the unbuilt SceneBuilder, so that a
    caller can append objects first (the reference composes its
    materialball benchmark this way, main.cu:428-432 and :675-786)."""
    if model_roots is None:
        model_roots = DEFAULT_MODEL_ROOTS + [os.path.dirname(os.path.abspath(path))]
    with open(path) as f:
        doc = safe_load(f.read())

    camera = Camera.from_yaml_block(doc["camera"])
    builder = SceneBuilder()
    if scene1_materials:
        register_scene1_materials(builder)
    for entry in doc.get("objects", []):
        (kind_name, obj), = entry.items()
        if "materialId" not in obj or "material" not in obj:
            # The reference CUDA renderer's loader crashes on such entries
            # (a yaml-cpp throw, main.cu:698-702); skip them with a warning.
            warnings.warn(f"{path}: skipping {kind_name} without materialId/material")
            continue
        material_id = int(obj["materialId"])
        _register_material(builder, material_id, obj["material"])
        prim_type = int(obj["type"])
        if prim_type == 0:  # Sphere (PrimitiveType order, Hitable.h:7-11)
            builder.sphere(tuple(obj["center"]), float(obj["radius"]), material_id)
        elif prim_type == 1:  # Plane
            builder.plane(
                position=tuple(obj["position"]),
                normal=tuple(obj["normal"]),
                extend=tuple(obj["extend"]),
                orientation=int(obj["orientation"]),
                material_id=material_id,
                two_sided=bool(obj.get("twoSide", True)),
            )
        elif prim_type == 2:  # TriangleMesh
            model_path = _resolve_model(obj["model"], model_roots)
            scale = tuple(obj.get("scale", (1.0, 1.0, 1.0)))
            rotate = tuple(obj.get("rotate", (0.0, 0.0, 0.0)))
            offset = tuple(obj.get("offset", (0.0, 0.0, 0.0)))
            if model_path.lower().endswith(".ply"):
                tris = load_ply(model_path, offset=offset)
            else:
                tris = load_obj(model_path, scale=scale, rotate=rotate, offset=offset)
            builder.mesh(tris, material_id)
        else:
            raise ValueError(f"unknown primitive type {prim_type} ({kind_name})")
    return builder, camera


__all__ = ["DEFAULT_MODEL_ROOTS", "load_scene", "load_scene_builder",
           "register_scene1_materials"]
