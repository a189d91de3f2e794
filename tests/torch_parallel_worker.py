"""The fit problem of tests/test_torch_parallel.py, and one rank of its
two-process gloo run (no JAX imported here: the ranks start quickly):

    python tests/torch_parallel_worker.py HOST:PORT RANK OUT.npy

Each rank renders 2 of the 4 tiles and the step sums the albedo gradient
over the ranks; rank 0 saves [gradient, loss] to OUT.npy.
"""

import sys

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
from raytracingthenextweekcuda_tpu_torch.models.scene import with_leaves
from raytracingthenextweekcuda_tpu_torch.ops import threefry


def fit_parts():
    """(params_to_scene, camera, cfg, target): material 0's red albedo of
    the sphere-plane preset against a 16x16, 2-spp render of the preset."""
    scene, camera = presets.diffuse_sphere_plane()
    rows = torch.from_numpy(np.asarray(scene.materials.albedo, np.float32))

    def params_to_scene(params):
        (a,) = params
        albedo = torch.cat([torch.stack([a, rows[0, 1], rows[0, 2]])[None], rows[1:]])
        return with_leaves(scene, {"materials.albedo": albedo})

    cfg = RenderConfig(width=16, height=16, spp=2, bounces=3)
    target = integrator.render_pass(scene, camera, threefry.key(2), cfg, 2,
                                    device="cpu") / 2
    return params_to_scene, camera, cfg, target


def fit_step(step_of):
    """(albedo gradient, loss) of one step from 0.3; `step_of(params_to_scene,
    camera, cfg)` makes the step."""
    params_to_scene, camera, cfg, target = fit_parts()
    a = torch.tensor(0.3, requires_grad=True)
    loss = step_of(params_to_scene, camera, cfg)([a], target, threefry.key(4))
    return float(a.grad), loss


def main(address: str, rank: int, out: str) -> None:
    import torch.distributed as dist

    from raytracingthenextweekcuda_tpu_torch.parallel.fit import make_fit_step
    from raytracingthenextweekcuda_tpu_torch.parallel.mesh import make_mesh
    from raytracingthenextweekcuda_tpu_torch.parallel.multihost import init_multihost

    init_multihost(address, 2, rank, timeout=60)
    grad, loss = fit_step(lambda p2s, camera, cfg: make_fit_step(
        p2s, camera, cfg, make_mesh(4, ["cpu"] * 4), 2))
    if rank == 0:
        np.save(out, np.asarray([grad, loss], np.float64))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
