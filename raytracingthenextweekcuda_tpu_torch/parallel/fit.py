"""Distributed inverse rendering (counterpart of
raytracingthenextweekcuda_tpu/parallel/fit.py).

The loss is the MSE of the tile-sharded render against the target. In one
process, autograd through the tiles sums their gradients, the reference's
psum. With `torch.distributed` initialized over several ranks
(parallel/multihost.py), each rank renders its share of the tiles, its
loss is its share of the global MSE (its pixels' squared errors over all
`num_pixels * 3` values), and the step sums every parameter's gradient
over the ranks with `all_reduce` before the optimizer steps.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
from raytracingthenextweekcuda_tpu_torch.parallel.mesh import (
    TileMesh,
    replicated,
    tile_sharding,
)
from raytracingthenextweekcuda_tpu_torch.parallel.render import _pass_local


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def local_tiles(mesh: TileMesh, num_pixels: int) -> list:
    """The (device, pixels) tiles this process renders: every tile in one
    process, a contiguous share of mesh.size / world size tiles on each
    rank of an initialized process group."""
    tiles = tile_sharding(mesh, num_pixels)
    if not _distributed():
        return tiles
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh.size % world:
        raise ValueError(f"mesh of {mesh.size} tiles over {world} ranks")
    share = mesh.size // world
    return tiles[rank * share:(rank + 1) * share]


def make_loss(params_to_scene, camera, cfg: RenderConfig, mesh: TileMesh, spp: int):
    """loss(params, target (H, W, 3), key words) = the MSE of the sharded
    render (`spp` samples, their mean) against the target; on a rank of a
    process group, this rank's share of it. The render goes through the
    differentiable wavefront (`fused_bounce=False`): the fused kernels are
    forward only."""
    cfg = dataclasses.replace(cfg, fused_bounce=False)
    first = mesh.devices[0]

    def loss(params, target, key):
        scene = params_to_scene(params)
        targets = replicated(mesh, target.reshape(-1, 3))
        sse = torch.zeros((), device=first)
        for device, pixels in local_tiles(mesh, cfg.num_pixels):
            img = _pass_local(scene, camera, key, cfg, spp, pixels, device) / spp
            sse = sse + ((img - targets[device][pixels]) ** 2).sum().to(first)
        return sse / (cfg.num_pixels * 3)

    return loss


def make_fit_step(params_to_scene, camera, cfg: RenderConfig, mesh: TileMesh,
                  spp: int, optimizer=None, lr: float = 2e-2):
    """step(params, target, key) -> the global loss (a float): one
    optimisation step of `params`, a list of leaf tensors that require grad
    (the same list at every call), in place. `optimizer` makes the
    optimizer from that list (a torch.optim class, say); None is Adam with
    apps/fit.py's settings (lr, betas 0.9 and 0.999, eps 1e-8). After the
    step, each parameter's `.grad` holds the gradient it took, summed over
    the ranks."""
    loss_fn = make_loss(params_to_scene, camera, cfg, mesh, spp)
    if optimizer is None:
        def optimizer(params):
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    made = []

    def step(params, target, key) -> float:
        params = list(params)
        if not made:
            made.append(optimizer(params))
        opt = made[0]
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(params, target, key)
        loss.backward()
        loss = loss.detach()
        if _distributed():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad, op=dist.ReduceOp.SUM)
            dist.all_reduce(loss, op=dist.ReduceOp.SUM)
        opt.step()
        return float(loss)

    return step


__all__ = ["local_tiles", "make_fit_step", "make_loss"]
