"""Several processes, and the scaling measurement (counterpart of
raytracingthenextweekcuda_tpu/parallel/multihost.py).

Every process runs the same program. `init_multihost` joins them in one
`torch.distributed` process group (NCCL between CUDA devices, gloo on the
CPU), over which parallel/fit.py sums gradients; the forward pass needs
no communication. `measure_scaling` times the tile-sharded render against
the number of tiles.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from raytracingthenextweekcuda_tpu_torch.ops import threefry
from raytracingthenextweekcuda_tpu_torch.parallel.mesh import make_mesh
from raytracingthenextweekcuda_tpu_torch.parallel.render import render_pass_sharded
from raytracingthenextweekcuda_tpu_torch.utils.timing import sync


def init_multihost(coordinator_address=None, num_processes=None, process_id=None,
                   timeout: float = 300.0) -> None:
    """`torch.distributed.init_process_group`, NCCL on CUDA and gloo on the
    CPU: at `tcp://coordinator_address` ("host:port") with `num_processes`
    ranks, this one `process_id`, or from the environment (`env://`:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). A no-op when the group is
    already initialized, or when the run is single-process: no argument
    and no WORLD_SIZE in the environment. An init that was asked for and
    fails (within `timeout` seconds) raises."""
    if dist.is_initialized():
        return
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args) and "WORLD_SIZE" not in os.environ:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
        timeout=datetime.timedelta(seconds=timeout))


def measure_scaling(scene, camera, cfg, device_counts=None, spp: int = 8,
                    verbose: bool = True, devices=None) -> dict:
    """{tiles: paths/s} of `render_pass_sharded` over meshes of the first
    n of `devices` (default: the visible CUDA devices), for n in
    `device_counts` (default: those of 1, 2, 4, ..., 32 that fit). Each
    is timed on the host clock after a warm-up pass, ended by a
    synchronize. Efficiency(n) = rate(n) / (n * rate(1))."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= len(devices)]
    results = {}
    key = threefry.key(0)
    for n in device_counts:
        mesh = make_mesh(n, devices)
        sync(render_pass_sharded(scene, camera, key, cfg, spp, mesh))  # warm-up
        t0 = time.perf_counter()
        sync(render_pass_sharded(scene, camera, threefry.fold_in(key, 1), cfg, spp,
                                 mesh))
        rate = cfg.num_pixels * spp / (time.perf_counter() - t0)
        results[n] = rate
        if verbose:
            base = results[device_counts[0]] * n / device_counts[0]
            print(f"  {n:3d} tiles: {rate / 1e6:8.2f} Mpaths/s "
                  f"(efficiency {rate / base * 100:5.1f}%)")
    return results


__all__ = ["init_multihost", "measure_scaling"]
