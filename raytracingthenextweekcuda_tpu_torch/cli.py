"""Command-line frontend of the port (counterpart of
raytracingthenextweekcuda_tpu/cli.py):

    rtnw-torch render --preset cornell --width 512 --height 512 --spp 32 --out render.png
    rtnw-torch bench  [--width 512 --height 512 --spp 128 --bounces 10]
    rtnw-torch bench --mesh   # tile-BVH mesh path, 512x512, 32 spp, 10 bounces
    rtnw-torch fit    [--steps 60] [--out fit.png]       # inverse rendering
    rtnw-torch fit --mesh [--steps 40] [--out fit_mesh.png]

All run on `--device` (default cuda); `--device cpu` uses the kernels'
plain torch versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_scene(name: str):
    from raytracingthenextweekcuda_tpu_torch.models import presets

    table = {
        "cornell": presets.cornell_box,
        "cornell-empty": lambda: presets.cornell_box(with_spheres=False,
                                                     with_cubes=False),
        "defocus": presets.defocus_blur,
        "rtiow-final": presets.rtiow_final,
        "sphere-plane": presets.diffuse_sphere_plane,
        "mesh": presets.mesh_showcase,
        "smallpt": presets.smallpt_spheres,
    }
    if name not in table:
        raise SystemExit(f"unknown preset '{name}' (choose from {sorted(table)})")
    return table[name]()


def cmd_render(args) -> int:
    import torch

    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.io.image import write_png
    from raytracingthenextweekcuda_tpu_torch.models import integrator
    from raytracingthenextweekcuda_tpu_torch.models.film import to_image
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    scene, camera = _build_scene(args.preset)
    scene = finalize(scene)  # a tile-BVH above 256 triangles
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       bounces=args.bounces)
    device = torch.device(args.device)
    print(f"rendering {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.bounces} on {device}", file=sys.stderr)
    t0 = time.perf_counter()
    film = integrator.render(scene, camera, cfg, device=device)
    image = to_image(film)  # copies to the host, so the render has finished
    dt = time.perf_counter() - t0
    write_png(args.out, image)
    print(f"rendered in {dt * 1000:.1f} ms "
          f"({cfg.num_pixels * cfg.spp / dt / 1e6:.2f} Mpaths/s) -> {args.out}",
          file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from raytracingthenextweekcuda_tpu_torch.apps.bench import (
        run_bench,
        run_mesh_bench,
    )

    if args.mesh:
        result = run_mesh_bench(width=args.width, height=args.height,
                                spp=args.spp or 32, bounces=args.bounces,
                                device=args.device)
    else:
        spp = args.spp or 128
        result = run_bench(width=args.width, height=args.height, spp=spp,
                           bounces=args.bounces, spp_per_pass=spp,
                           device=args.device)
    print(json.dumps(result))
    return 0


def cmd_fit(args) -> int:
    from raytracingthenextweekcuda_tpu_torch.apps.fit import run_fit, run_fit_mesh

    if args.mesh:
        return run_fit_mesh(steps=40 if args.steps is None else args.steps,
                            out=args.out or "fit_mesh.png", device=args.device)
    return run_fit(steps=60 if args.steps is None else args.steps,
                   out=args.out or "fit.png", device=args.device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rtnw-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="render a preset to PNG")
    pr.add_argument("--preset", default="cornell", help="built-in scene preset")
    pr.add_argument("--width", type=int, default=512)
    pr.add_argument("--height", type=int, default=512)
    pr.add_argument("--spp", type=int, default=32)
    pr.add_argument("--bounces", type=int, default=10)
    pr.add_argument("--device", default="cuda")
    pr.add_argument("--out", default="render.png")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="headline or mesh benchmark, one JSON line")
    pb.add_argument("--mesh", action="store_true",
                    help="the tile-BVH mesh benchmark (32 spp in passes of 16)")
    pb.add_argument("--width", type=int, default=512)
    pb.add_argument("--height", type=int, default=512)
    pb.add_argument("--spp", type=int, default=0,
                    help="default 128, or 32 with --mesh")
    pb.add_argument("--bounces", type=int, default=10)
    pb.add_argument("--device", default="cuda")
    pb.set_defaults(fn=cmd_bench)

    pf = sub.add_parser("fit", help="inverse rendering through the "
                        "differentiable wavefront (96x96, 8 spp, 4 bounces)")
    pf.add_argument("--mesh", action="store_true",
                    help="fit a triangle mesh's per-axis scale through the "
                         "tile-BVH path instead of two spheres")
    pf.add_argument("--steps", type=int, default=None,
                    help="default 60, or 40 with --mesh")
    pf.add_argument("--out", default=None,
                    help="target and fit side by side (default fit.png, or "
                         "fit_mesh.png with --mesh)")
    pf.add_argument("--device", default="cuda")
    pf.set_defaults(fn=cmd_fit)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
