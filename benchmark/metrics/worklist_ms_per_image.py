"""Device time an image, in ms, of the operations enqueued inside the
work-list build (`k4.worklist`: the exact pass's slab test of every live
ray against every leaf box, the per-block reductions and the list sort)."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None:
        return None
    return spans.per_image(ctx.trace, spans.device_ns(ctx.trace, ("k4.worklist",)),
                           1e-6)
