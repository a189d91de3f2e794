"""Device time an image, in ms, of the operations enqueued inside the
wavefront's sort and unsort (`wavefront.sort`, `wavefront.unsort`)."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None:
        return None
    ns = spans.device_ns(ctx.trace, ("wavefront.sort", "wavefront.unsort"))
    return spans.per_image(ctx.trace, ns, 1e-6)
