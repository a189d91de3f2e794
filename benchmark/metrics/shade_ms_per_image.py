"""Summed profiled device time of the shade kernel (`shade_kernel`: the
sorted wavefront's bounce after K4 in one launch) an image, in ms.

The program's `wavefront.shade` span holds that launch and no other
device operation, so the kernel's records are the span's operations. They
are read by name, as `k4_ms_per_image` reads K4's, and not through
`benchmark/spans.py`'s pairing of operations with enqueue calls, which
gives nothing when the host's and the device's clocks drift apart. None
where the program has no such kernel."""


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None or not ctx.trace.jobs:
        return None
    shade = ctx.trace.kernels("shade_kernel")
    if not shade:
        return None
    return sum(e[2] for e in shade) * 1e-6 / ctx.trace.jobs
