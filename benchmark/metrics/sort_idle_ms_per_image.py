"""Device idle time an image, in ms, while the host is inside the
wavefront's sort (`wavefront.sort`: the key, the sort, the live count's
host read and the compaction)."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None:
        return None
    return spans.per_image(ctx.trace, spans.idle_ns(ctx.trace, ("wavefront.sort",)),
                           1e-6)
