"""The sorted wavefront's shading after K4, in one launch of
csrc/shade_kernel.cu.

A bounce of models/integrator._trace_sorted finds each ray's winners with
K3 and K4 (ops/fused.winners). `shade` then does the rest of the bounce:
it merges the two winners (ops/fused.merge), recomputes the winner's hit
record from the DeviceScene's tables (ops/fused._recompute), reads the
material row and the bounce's pcg4d uniforms, scatters for the kinds the
scene uses (ops/materials.scatter) and does the bookkeeping of
models/integrator._shade: the sky or zero on a miss, the emission,
the throughput, Russian roulette and the next ray. It returns the new
state (rays, throughput, radiance, alive); the rays keep their time.

CUDA tensors launch the kernel (or raise); CPU tensors run
`shade_reference`, those torch ops themselves, which are the kernel's
plain version and run on any device. The kernel is forward only: the
caller takes `shade_reference` where a table the body reads needs a
gradient.
"""

from __future__ import annotations

import torch

from raytracingthenextweekcuda_tpu_torch.ops.cuda import launch
from raytracingthenextweekcuda_tpu_torch.ops.fused import (
    DeviceScene,
    Winners,
    _recompute,
    merge,
)
from raytracingthenextweekcuda_tpu_torch.ops.materials import MaterialRows
from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays
from raytracingthenextweekcuda_tpu_torch.ops.rng import SlotCtx

# The kernel's flags: the sky on a miss, Russian roulette at this bounce;
# bits 8-15 the material kinds the scene uses.
FLAG_SKY = 1
FLAG_RR = 2
_KINDS = 8


def flags(cfg, used_kinds, bounce_idx: int) -> int:
    """The kernel's flags for bounce `bounce_idx` under `cfg` (a
    RenderConfig) with `used_kinds` (None: every kind)."""
    kinds = range(_KINDS) if used_kinds is None else used_kinds
    used = sum(1 << int(k) for k in set(kinds) if 0 <= int(k) < _KINDS)
    rr = cfg.russian_roulette and bounce_idx >= cfg.rr_start_bounce
    return (FLAG_SKY if cfg.sky_background else 0) | (FLAG_RR if rr else 0) | used << 8


def shade(ds: DeviceScene, mats: MaterialRows, used_kinds, cfg, state,
          win: Winners, ctx: SlotCtx, slot: torch.Tensor, bounce_idx: int):
    """The state after bounce `bounce_idx` of the wavefront `state` = (rays,
    throughput (N, 3), radiance (N, 3), alive (N,) bool), whose winners are
    `win` and whose rays sit at wavefront slots `slot` (N,) int64 of `ctx`.
    CUDA tensors launch the shade kernel, CPU tensors run the plain version."""
    return launch.by_device(state[0].origin.device, _launch, shade_reference, ds,
                            mats, used_kinds, cfg, state, win, ctx, slot, bounce_idx)


def shade_reference(ds: DeviceScene, mats: MaterialRows, used_kinds, cfg, state,
                    win: Winners, ctx: SlotCtx, slot: torch.Tensor,
                    bounce_idx: int):
    """Plain version of the shade kernel, in torch on any device: the merge,
    the recompute and models/integrator._shade, the differentiable
    wavefront's body after its closest hit."""
    from raytracingthenextweekcuda_tpu_torch.models import integrator

    hit = _recompute(ds, state[0], *merge(win))
    return integrator._shade(mats, used_kinds, cfg, state, hit, ctx.at(slot),
                             bounce_idx)


def _launch(ds: DeviceScene, mats: MaterialRows, used_kinds, cfg, state,
            win: Winners, ctx: SlotCtx, slot, bounce_idx: int):
    rays, throughput, radiance, alive = state
    dev = rays.origin.device
    n = rays.count
    i64, f32, i32 = torch.int64, torch.float32, torch.int32
    specs = [(rays.origin, f32, (n, 3)), (rays.direction, f32, (n, 3)),
             (rays.time, f32, (n,)), (throughput, f32, (n, 3)),
             (radiance, f32, (n, 3)), (alive, torch.bool, (n,)),
             (win.t, f32, (n,)), (win.code, i32, (n,)), (slot, i64, (n,)),
             (ctx.base0, i64, (ctx.base0.shape[0],)),
             (ctx.base1, i64, (ctx.base0.shape[0],)),
             (ds.spheres, f32, (ds.spheres.shape[0], 10)),
             (ds.planes, f32, (ds.planes.shape[0], 7)),
             (ds.triangles, f32, (ds.triangles.shape[0], 10)),
             (mats.kind, i64, (mats.kind.shape[0],)),
             (mats.albedo, f32, (mats.kind.shape[0], 3)),
             (mats.param, f32, (mats.kind.shape[0],)),
             (mats.emission, f32, (mats.kind.shape[0], 3))]
    if (win.t_m is None) != (win.c_m is None):
        raise ValueError("shade input: K4's t and code, both or neither")
    if win.t_m is not None:
        specs += [(win.t_m, f32, (n,)), (win.c_m, i32, (n,))]
    if ctx.pixel is not None:
        specs.append((ctx.pixel, i64, (ctx.pixel.shape[0],)))
    launch.check("shade", dev, specs)
    if ctx.n < 1 or ctx.m < 1:
        raise ValueError(f"shade input: slot divisors {ctx.n}, {ctx.m} below 1")
    origin, direction, tp, rad = (torch.empty((n, 3), dtype=f32, device=dev)
                                  for _ in range(4))
    alive_out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return Rays(origin, direction, rays.time), tp, rad, alive_out

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch.call(
        "shade kernel", "rtnw_shade", dev,
        rays.origin.data_ptr(), rays.direction.data_ptr(), rays.time.data_ptr(),
        throughput.data_ptr(), radiance.data_ptr(), alive.data_ptr(),
        win.t.data_ptr(), win.code.data_ptr(), ptr(win.t_m), ptr(win.c_m),
        slot.data_ptr(), ptr(ctx.pixel), ctx.base0.data_ptr(), ctx.base1.data_ptr(),
        int(ctx.n), int(ctx.m), ds.spheres.data_ptr(), int(ds.spheres.shape[0]),
        ds.planes.data_ptr(), int(ds.planes.shape[0]), ds.triangles.data_ptr(),
        int(ds.triangles.shape[0]), mats.kind.data_ptr(), mats.albedo.data_ptr(),
        mats.param.data_ptr(), mats.emission.data_ptr(), int(n), int(bounce_idx),
        flags(cfg, used_kinds, bounce_idx), origin.data_ptr(), direction.data_ptr(),
        tp.data_ptr(), rad.data_ptr(), alive_out.data_ptr(), count=("shade",))
    return Rays(origin, direction, rays.time), tp, rad, alive_out


__all__ = ["flags", "shade", "shade_reference"]
