"""Mesh benchmark scenes (counterpart of
raytracingthenextweekcuda_tpu/apps/bench_scenes.py).

Each builder returns (scene, camera, asset) with the scene not finalized.
The reference builds these from its published assets (cornellbox0.yaml
with suzanne0.ply, cornellbox2.yaml with materialball.ply), which are not
in this repository; like the reference without its assets, the port
renders the procedural stand-ins, and `asset` says so. Loading the real
assets waits until they are in the repository.
"""

from __future__ import annotations

from raytracingthenextweekcuda_tpu_torch.models import presets

STAND_IN = "procedural stand-in (reference assets not in the repository)"


def published_mesh_scene():
    """Stand-in for the reference's published mesh benchmark (Cornell plus
    the 967-triangle suzanne): a 960-triangle UV sphere under a light."""
    scene, camera = presets.mesh_showcase(n_lat=16, n_lon=32)
    return scene, camera, f"mesh_showcase(16, 32), {STAND_IN}"


def stress_mesh_scene():
    """Stand-in for the reference's stress scene (cornellbox2 plus the
    46,816-triangle materialball): a 16,128-triangle UV sphere."""
    scene, camera = presets.mesh_showcase(n_lat=64, n_lon=128)
    return scene, camera, f"mesh_showcase(64, 128), {STAND_IN}"


__all__ = ["STAND_IN", "published_mesh_scene", "stress_mesh_scene"]
