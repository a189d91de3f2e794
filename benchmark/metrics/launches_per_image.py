"""Device kernels launched an image (torch.profiler's kernel records)."""


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None or not ctx.trace.jobs:
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.trace.jobs if n else None
