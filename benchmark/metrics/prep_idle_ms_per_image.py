"""Device idle time an image, in ms, while the host prepares a pass: inside
the `integrator.prep` (camera frame, key split), `k1.prep` (K1's inputs to
the device) and `wavefront.prep` (the device scene, each group's rays and
key bases) spans."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None:
        return None
    idle = spans.idle_ns(ctx.trace, ("integrator.prep", "k1.prep", "wavefront.prep"))
    return spans.per_image(ctx.trace, idle, 1e-6)
