"""The program's side of the benchmark's scene data: a configuration's
scene built through the program's public `SceneBuilder` and `Camera`.
This is the only module that hands the program its scene."""

from __future__ import annotations

from benchmark.scenedata import KINDS, ORIENTATIONS, scene_meshes


def build_scene(cfg: dict):
    """(scene, camera) of the program, built from the configuration's data
    through its public SceneBuilder and Camera; not finalized."""
    from raytracingthenextweekcuda_tpu_torch.models.camera import Camera
    from raytracingthenextweekcuda_tpu_torch.models.scene import SceneBuilder

    sc = cfg["scene"]
    b = SceneBuilder()
    for m in sc["materials"]:
        b.material(int(m["id"]), KINDS[m["kind"]], tuple(m.get("albedo", (0, 0, 0))),
                   float(m.get("param", 0.0)), tuple(m.get("emission", (0, 0, 0))))
    meshes = iter(scene_meshes(cfg))
    for p in sc["primitives"]:
        if p["type"] == "sphere":
            b.moving_sphere(p["center0"], p.get("center1", p["center0"]),
                            p.get("time0", 0.0), p.get("time1", 1.0),
                            p["radius"], p["material"])
        elif p["type"] == "plane":
            b.plane(p["position"], p["normal"], p["extend"],
                    ORIENTATIONS[p["orientation"]], p["material"],
                    two_sided=p.get("two_sided", True))
        elif p["type"] == "mesh":
            verts, mid = next(meshes)
            b.mesh(verts, mid)
        else:
            raise ValueError(f"unknown primitive type {p['type']!r}")
    cam = sc["camera"]
    camera = Camera.make(eye=cam["eye"], center=cam["center"],
                         up=cam.get("up", (0.0, 1.0, 0.0)), fov=cam["fov"],
                         aperture=cam["aperture"],
                         focus_distance=cam["focus_distance"],
                         time0=cam.get("time0", 0.0), time1=cam.get("time1", 0.0))
    return b.build(), camera
