"""Device idle time an image, in ms, while the host is inside a
sorted-wavefront bounce (`wavefront.bounce`: the torch bounce body around
K3, the work-list build and K4)."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None:
        return None
    return spans.per_image(ctx.trace, spans.idle_ns(ctx.trace, ("wavefront.bounce",)),
                           1e-6)
