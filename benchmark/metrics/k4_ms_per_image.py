"""Summed profiled device time of the work-list winner kernel K4
(`bvh_winner_kernel`) an image, in ms."""


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None or not ctx.trace.jobs:
        return None
    k4 = ctx.trace.kernels("bvh_winner_kernel")
    if not k4:
        return None
    return sum(e[2] for e in k4) * 1e-6 / ctx.trace.jobs
