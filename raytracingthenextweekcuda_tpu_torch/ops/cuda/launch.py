"""How the port calls a hand-written kernel, and on which device.

Every kernel wrapper in ops/cuda goes through these functions:
- `by_device`: CUDA tensors launch the kernel, CPU tensors run its plain
  version, any other device raises. Dispatch is by device, never by
  failure: a failed build, load or launch raises and nothing falls back.
- `check`: each input's device, dtype, shape and contiguity, before a
  launch reads it through a raw pointer.
- `call`: one launch of a C entry of the kernels' library (ops/cuda/build)
  on the current stream. A non-zero return raises; a launch that returns
  counts in `LAUNCHES`.

It also holds the port's device rule (`device_or_raise`: CUDA by default,
raising without a card) and the guard of the forward-only kernels
(`ForwardOnly`, `grad_probe`, `guard`): a backward through a kernel raises
instead of giving zero gradients.
"""

from __future__ import annotations

import collections

import torch

from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

# Launches of each kernel, counted by `call`: "K1", "K2", "K0" (their
# tile-BVH instantiations also under "K1-BVH", "K2-BVH", "K0-BVH"), "K3",
# "K4" (its stats instantiation under "K4-stats" only), "worklist" and
# "shade". The tests read them; no metric does.
LAUNCHES: collections.Counter = collections.Counter()


def by_device(dev: torch.device, launch, plain, *args):
    """`launch(*args)` on a CUDA device, `plain(*args)` on the CPU."""
    if dev.type == "cuda":
        return launch(*args)
    if dev.type == "cpu":
        return plain(*args)
    raise ValueError(f"unsupported device {dev}")


def check(kernel: str, dev, specs) -> None:
    """Raise unless each (tensor, dtype, shape) of `specs` is a contiguous
    tensor of that dtype and shape on `dev`."""
    for t, dtype, shape in specs:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{kernel} input {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: expected contiguous {shape} {dtype} "
                             f"on {dev}")


def call(label: str, entry: str, dev, *args, count: tuple) -> None:
    """Launch the library's `entry` with `args` and the current stream of
    `dev`; raise on a non-zero return, else count one launch under each
    name of `count`. The library is looked up on every call, so a tool may
    swap `build._LIB` for a variant's."""
    lib = build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{label} launch failed: {lib.rtnw_error_string(err).decode()} ({err})")
    LAUNCHES.update(count)


def device_or_raise(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but CUDA is not available")
    return device


FORWARD_ONLY_MESSAGE = (
    "cfg.fused_bounce=True renders with the forward-only bounce kernels "
    "(K1, K2, K0); set fused_bounce=False for differentiable rendering "
    "(the torch wavefront)."
)


class ForwardOnly(torch.autograd.Function):
    """Identity that fails loudly under backward.

    The kernels have no backward, and their outputs would carry no graph:
    differentiating a fused render would silently give zero gradients.
    `guard` joins a kernel's output to its inputs through this function,
    so a backward through it raises instead."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(FORWARD_ONLY_MESSAGE)


def grad_probe(*tensors):
    """Exactly 0 in the forward, carrying every tensor of `tensors` that
    requires grad through `ForwardOnly` (0.0 when none does)."""
    live = [t for t in tensors if torch.is_tensor(t) and t.requires_grad]
    if not live:
        return 0.0
    probe = ForwardOnly.apply(sum(t.sum() for t in live))
    return probe - probe.detach()


def guard(out: torch.Tensor, *inputs) -> torch.Tensor:
    """A kernel's output joined to its inputs by `grad_probe`."""
    probe = grad_probe(*inputs)
    return out if isinstance(probe, float) else out + probe


__all__ = ["FORWARD_ONLY_MESSAGE", "ForwardOnly", "LAUNCHES", "by_device", "call",
           "check", "device_or_raise", "grad_probe", "guard"]
