"""Command-line frontend of the port (counterpart of
raytracingthenextweekcuda_tpu/cli.py):

    rtnw-torch render --preset cornell --width 512 --height 512 --spp 32 --out render.png
    rtnw-torch render --scene scenes/cornellbox.yaml [--bvh] [--seed 1984]
                      [--spp-per-pass 8] [--russian-roulette] [--progressive]
                      [--checkpoint render.npz] [--debug-nan]
    rtnw-torch render --preset cornell --shards 4   # 4 pixel tiles, one a device
    rtnw-torch bench  [--width 512 --height 512 --spp 128 --bounces 10]
    rtnw-torch bench --mesh          # tile-BVH mesh path, 512x512, 32 spp, 10 bounces
    rtnw-torch bench --mesh-stress   # the stress stand-in, same, with K4's leaf counters
    rtnw-torch bench --mesh-large    # the 261k-triangle stand-in, 8 spp, 5 bounces
    rtnw-torch fit    [--steps 60] [--out fit.png]       # inverse rendering
    rtnw-torch fit --mesh [--steps 40] [--out fit_mesh.png]
    rtnw-torch live   [--preset cornell] [--view terminal|http] [--script "w enter x"]

All run on `--device` (default cuda); `--device cpu` uses the kernels'
plain torch versions.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_scene(args):
    from raytracingthenextweekcuda_tpu_torch.models import presets

    if args.scene:
        from raytracingthenextweekcuda_tpu_torch.io.yaml_scene import load_scene

        return load_scene(args.scene)
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
    name = args.preset or "cornell"
    if name not in table:
        raise SystemExit(f"unknown preset '{name}' (choose from {sorted(table)})")
    return table[name]()


def cmd_render(args) -> int:
    import torch

    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.io.image import write_png
    from raytracingthenextweekcuda_tpu_torch.models.checkpoint import render_resumable
    from raytracingthenextweekcuda_tpu_torch.models.film import to_image
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.utils.log import report_devices
    from raytracingthenextweekcuda_tpu_torch.utils.progress import Progress
    from raytracingthenextweekcuda_tpu_torch.utils.timing import Timer, throughput

    print(report_devices(), file=sys.stderr)  # Utils::queryDeviceProperties
    scene, camera = _build_scene(args)
    # --bvh forces the tile-BVH, as the reference's code does (its help
    # text says LBVH); without it, a tile-BVH above 256 triangles.
    scene = finalize(scene, use_bvh=True if args.bvh else None)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       bounces=args.bounces, spp_per_pass=args.spp_per_pass,
                       russian_roulette=args.russian_roulette, seed=args.seed)
    device = torch.device(args.device)
    if args.shards > 1:
        from raytracingthenextweekcuda_tpu_torch.parallel.mesh import make_mesh
        from raytracingthenextweekcuda_tpu_torch.parallel.render import render_sharded

        # One tile a card where there are enough; else all on `device`.
        enough = device.type == "cuda" and torch.cuda.device_count() >= args.shards
        mesh = make_mesh(args.shards, devices=None if enough else [device] * args.shards)
        timer = Timer().start()
        film = render_sharded(scene, camera, cfg, mesh)
        ms = timer.stop(film)
        write_png(args.out, to_image(film))
        print(f"rendered on {mesh.size} shards in {ms:.1f} ms -> {args.out}",
              file=sys.stderr)
        return 0
    passes = cfg.passes()
    print(f"rendering {cfg.width}x{cfg.height} spp={cfg.spp} bounces={cfg.bounces} "
          f"in {len(passes)} passes on {device}", file=sys.stderr)
    progress = Progress(len(passes))  # 10%-step prints (main.cu:197-203)
    timer = Timer().start()

    def after_pass(i, film):
        if args.debug_nan and not bool(torch.isfinite(film.accum).all()):
            raise FloatingPointError(f"pass {i}: the film holds a NaN or an infinity")
        if args.progressive:  # the realtime frontend's accumulate protocol
            write_png(args.out, to_image(film))
            print(f"  pass {i}: {film.sample_count} spp, "
                  f"{timer.stop(film):.0f} ms -> {args.out}", file=sys.stderr)
        progress.update()

    film = render_resumable(scene, camera, cfg, args.checkpoint, device=device,
                            after_pass=after_pass)
    ms = timer.stop(film)
    write_png(args.out, to_image(film))
    print(f"rendered in {ms:.1f} ms "
          f"({throughput(cfg.num_pixels * cfg.spp, ms) / 1e6:.2f} Mpaths/s) -> "
          f"{args.out}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from raytracingthenextweekcuda_tpu_torch.apps import bench

    bounces = args.bounces
    if bounces is None:
        bounces = 5 if args.mesh_large else 10
    if args.mesh:
        result = bench.run_mesh_bench(width=args.width, height=args.height,
                                      spp=args.spp or 32, bounces=bounces,
                                      device=args.device)
    elif args.mesh_stress:
        result = bench.run_mesh_stress(width=args.width, height=args.height,
                                       spp=args.spp or 32, bounces=bounces,
                                       device=args.device)
    elif args.mesh_large:
        spp = args.spp or 8
        result = bench.run_mesh_large(width=args.width, height=args.height,
                                      spp=spp, bounces=bounces, spp_per_pass=spp,
                                      device=args.device)
    else:
        spp = args.spp or 128
        result = bench.run_bench(width=args.width, height=args.height, spp=spp,
                                 bounces=bounces, spp_per_pass=spp,
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


def cmd_live(args) -> int:
    """Live progressive preview: a display loop (terminal half-blocks or an
    HTTP page on 127.0.0.1) over an InteractiveSession with the reference's
    WASDQE/orbit/FOV controls and dirty reset (OpenGLFrontend.cpp:538-612,
    main.cu:875-888)."""
    from raytracingthenextweekcuda_tpu_torch.apps.interactive import (
        InteractiveSession,
    )
    from raytracingthenextweekcuda_tpu_torch.apps.viewer import (
        HTTPViewer,
        TerminalViewer,
        run_live,
    )
    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize

    scene, camera = _build_scene(args)
    scene = finalize(scene)
    cfg = RenderConfig(width=args.width, height=args.height, spp=1,
                       bounces=args.bounces)
    session = InteractiveSession(scene, camera, cfg,
                                 spp_per_frame=args.spp_per_frame, device=args.device)
    if args.view == "http":
        viewer = HTTPViewer(port=args.port)
        print(f"serving live view on http://127.0.0.1:{viewer.port}/", file=sys.stderr)
    else:
        viewer = TerminalViewer()
    commands = args.script.split() if args.script else None
    print("controls: w/s walk a/d strafe q/e raise j/l yaw i/k pitch "
          "o orbit [/] fov enter=screenshot . idle x quit", file=sys.stderr)
    try:
        shots = run_live(session, commands=commands, viewer=viewer,
                         frames_per_command=args.frames_per_command)
    finally:
        if args.view == "http":
            viewer.close()
    for shot in shots:
        print(f"screenshot -> {shot}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rtnw-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="render a scene file or a preset to PNG")
    pr.add_argument("--scene", help="YAML scene file (the reference's schema)")
    pr.add_argument("--preset", help="built-in scene preset (default cornell)")
    pr.add_argument("--width", type=int, default=512)
    pr.add_argument("--height", type=int, default=512)
    pr.add_argument("--spp", type=int, default=32)
    pr.add_argument("--bounces", type=int, default=10)
    pr.add_argument("--spp-per-pass", type=int, default=0,
                    help="samples a pass (one K1 launch); 0 = all at once")
    pr.add_argument("--seed", type=int, default=1984)
    pr.add_argument("--russian-roulette", action="store_true")
    pr.add_argument("--bvh", action="store_true",
                    help="render meshes through a tile-BVH whatever their size")
    pr.add_argument("--progressive", action="store_true",
                    help="rewrite the PNG after every pass")
    pr.add_argument("--checkpoint", metavar="PATH",
                    help="save the film here after each pass; resume from it "
                         "if it exists and matches the scene and camera")
    pr.add_argument("--debug-nan", action="store_true",
                    help="raise after a pass that leaves a NaN or an infinity "
                         "in the film")
    pr.add_argument("--shards", type=int, default=1,
                    help="render N pixel tiles, one a CUDA card where there are "
                         "N, else all on --device, one after another")
    pr.add_argument("--device", default="cuda")
    pr.add_argument("--out", default="render.png")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="headline or mesh benchmark, one JSON line")
    which = pb.add_mutually_exclusive_group()
    which.add_argument("--mesh", action="store_true",
                       help="mesh metric 1: the tile-BVH mesh benchmark (32 spp in "
                            "passes of 16)")
    which.add_argument("--mesh-stress", action="store_true",
                       help="mesh metric 2: the stress stand-in (32 spp in passes "
                            "of 16) with K4's leaf counters")
    which.add_argument("--mesh-large", action="store_true",
                       help="mesh metric 3: the large stand-in (8 spp, 5 bounces)")
    pb.add_argument("--width", type=int, default=512)
    pb.add_argument("--height", type=int, default=512)
    pb.add_argument("--spp", type=int, default=0,
                    help="default 128, or 32 with --mesh/--mesh-stress, 8 with "
                         "--mesh-large")
    pb.add_argument("--bounces", type=int, default=None,
                    help="default 10, or 5 with --mesh-large")
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

    pl = sub.add_parser("live", help="live progressive preview with an "
                        "interactive camera")
    pl.add_argument("--scene", help="YAML scene file (the reference's schema)")
    pl.add_argument("--preset", help="built-in scene preset (default cornell)")
    pl.add_argument("--width", type=int, default=256)
    pl.add_argument("--height", type=int, default=256)
    pl.add_argument("--bounces", type=int, default=5)
    pl.add_argument("--spp-per-frame", type=int, default=1,
                    help="samples accumulated per frame (main.cu:883)")
    pl.add_argument("--frames-per-command", type=int, default=2)
    pl.add_argument("--view", choices=("terminal", "http"), default="terminal")
    pl.add_argument("--port", type=int, default=8000)
    pl.add_argument("--script", help="space-separated commands (a headless "
                    "demo); without it the commands are read from stdin")
    pl.add_argument("--device", default="cuda")
    pl.set_defaults(fn=cmd_live)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
