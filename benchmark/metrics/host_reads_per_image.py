"""Host reads of device values an image: the program's `host.read` spans,
each a synchronization of the host with the device."""

from benchmark import spans


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None:
        return None
    return spans.per_image(ctx.trace, spans.count(ctx.trace, "host.read"))
