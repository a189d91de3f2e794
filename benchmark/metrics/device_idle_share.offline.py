"""Share of the traced window's wall time in which no operation ran on the
device, over whole image jobs (torch.profiler)."""


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
