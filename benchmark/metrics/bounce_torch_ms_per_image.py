"""Device time an image, in ms, of the torch operations of the sorted
wavefront's bounce body: enqueued inside `wavefront.bounce` and outside K3
(`k3.intersect`), the work-list build (`k4.worklist`) and K4 (`k4.winner`):
the root query, K4's padding, the hit recompute, the BSDF and the
bookkeeping."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None:
        return None
    ns = spans.device_ns(ctx.trace, ("wavefront.bounce",),
                         ("k3.intersect", "k4.worklist", "k4.winner"))
    return spans.per_image(ctx.trace, ns, 1e-6)
