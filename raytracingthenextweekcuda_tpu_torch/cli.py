"""Command-line frontend of the port (counterpart of
raytracingthenextweekcuda_tpu/cli.py):

    rtnw-torch render --preset cornell --width 512 --height 512 --spp 32 --out render.png
    rtnw-torch bench  [--width 512 --height 512 --spp 128 --bounces 10]

Both run on `--device` (default cuda); `render --device cpu` uses the
render kernel's plain torch version.
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
    scene = finalize(scene, use_bvh=False)
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
    from raytracingthenextweekcuda_tpu_torch.apps.bench import run_bench

    result = run_bench(width=args.width, height=args.height, spp=args.spp,
                       bounces=args.bounces, spp_per_pass=args.spp,
                       device=args.device)
    print(json.dumps(result))
    return 0


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

    pb = sub.add_parser("bench", help="headline benchmark, one JSON line")
    pb.add_argument("--width", type=int, default=512)
    pb.add_argument("--height", type=int, default=512)
    pb.add_argument("--spp", type=int, default=128)
    pb.add_argument("--bounces", type=int, default=10)
    pb.add_argument("--device", default="cuda")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
