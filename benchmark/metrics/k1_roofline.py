"""K1's share of its roofline, in %: the least time the card could take
for an image's K1 work (roofline.k1_bound_s, from the live path-bounces
the reference counted on its judged pixels, scaled to the image) over
K1's profiled device time an image."""

from benchmark import roofline


def read(ctx):
    if ctx.kind != "offline" or ctx.trace is None or not ctx.path_bounces:
        return None
    k1 = [e for e in ctx.trace.kernels("render_kernel") if "<true>" not in e[0]]
    if not k1 or not ctx.trace.jobs:
        return None
    t = ctx.traffic
    pixels = t["width"] * t["height"]
    per_image = (sum(ctx.path_bounces) / len(ctx.path_bounces)
                 * pixels / ctx.judged_pixels)
    k1_s = sum(e[2] for e in k1) * 1e-9 / ctx.trace.jobs
    return 100.0 * roofline.k1_bound_s(ctx.config, per_image, pixels, t["spp"]) / k1_s
