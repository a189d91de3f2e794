"""Time K2 and the tile-BVH walk's kernels in variants of their design.

    python3 tools/walk_steps.py [--variants shipped,regen_1,...]

Builds variants of csrc/render_kernel.cu that differ from the shipped
source in one step each, by text substitution:
  - `regen_N`: `kRegenLanes`, the waiting lanes of a K1 or K2 warp at which
    they start new paths (1: each lane at once);
  - `k2_walk_ctas_N`: `kPathWalkCtas`, the CTAs a SM that K2 with the walk
    is compiled for (`__launch_bounds__(kThreads, N)`, which caps the
    registers a thread so that N CTAs fit on an SM; 5 leaves its 92
    registers uncapped);
  - `walk_min_ctas_N`: the same cap on the `<true>` instantiations of K1
    and K0 (the walk's), `<false>` left as it is.
Each builds with the package's nvcc flags (tools/k1_steps.py's builder,
one process per variant, started together), then serves the package's
wrappers in turn, every variant once in order and once in reverse order.
Times are device sums from torch.profiler over repeated launches: K2 on
the Cornell primary wavefront (512x512, 10 bounces), K2-BVH on the
published mesh stand-in's (512x512, 10 bounces), K1-BVH over one 16-spp
pass of the mesh benchmark and K0-BVH over the mesh wavefront's second
bounce. Beside each: ptxas's registers and spills and the CTAs a SM. Every
variant's outputs must equal the shipped one's bit for bit. Prints one
JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from k1_steps import _build, _sub  # noqa: E402

CONSTANTS = {"regen_": "kRegenLanes", "k2_walk_ctas_": "kPathWalkCtas"}
ENTRIES = ("__launch_bounds__(kRenderThreads)\nrender_kernel(",
           "__launch_bounds__(kThreads)\nbounce_kernel(")


def variant(src: str, name: str) -> str:
    """The shipped source with the one step `name` changed."""
    if name == "shipped":
        return src
    for prefix, const in CONSTANTS.items():
        if name.startswith(prefix):
            pattern = re.compile(rf"constexpr int {const} = \d+;")
            if len(pattern.findall(src)) != 1:
                raise RuntimeError(f"render_kernel.cu: no single {const}")
            return pattern.sub(f"constexpr int {const} = {name[len(prefix):]};", src)
    if name.startswith("walk_min_ctas_"):
        n = name[14:]
        for anchor in ENTRIES:
            threads = anchor[len("__launch_bounds__("):anchor.index(")")]
            src = _sub(src, anchor, anchor.replace(
                f"({threads})", f"({threads}, kBvh ? {n} : 1)"))
        return src
    raise ValueError(name)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="shipped,regen_1,regen_8,k2_walk_ctas_5,"
                    "k2_walk_ctas_8,walk_min_ctas_6")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("walk_steps: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _ptxas_by_entry
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes
    from raytracingthenextweekcuda_tpu_torch.apps.bench import card_info
    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models import presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    src = (build.CSRC_DIR / "render_kernel.cu").read_text()
    sources = {name: variant(src, name) for name in args.variants.split(",")}
    dev = torch.device("cuda", 0)
    main_lib = build.load()
    libs = {}
    for name, (path, log) in _build(sources).items():
        lib = ctypes.CDLL(str(path))
        for fn in ("rtnw_render_samples", "rtnw_path_trace", "rtnw_bounce_step",
                   "rtnw_render_occupancy", "rtnw_error_string"):
            getattr(lib, fn).argtypes = getattr(main_lib, fn).argtypes
            getattr(lib, fn).restype = getattr(main_lib, fn).restype
        libs[name] = (lib, {e: "; ".join(p) for e, p in _ptxas_by_entry(log).items()})

    cfg = RenderConfig(width=512, height=512, spp=16, bounces=10, spp_per_pass=16)
    key = threefry.key(cfg.seed)
    cornell, ccam = presets.cornell_box()
    cornell = finalize(cornell)
    mesh, mcam, _ = bench_scenes.published_mesh_scene()
    mesh = finalize(mesh)

    def wavefront(scene, camera):
        rays, ctx = cam.generate_rays(cam.derive(camera, 1.0),
                                      threefry.split(key, 1)[0], 512, 512, device=dev)
        return rays, ctx, bk.path_inputs(scene.packed, rays, ctx, cfg)

    _, _, k2_inp = wavefront(cornell, ccam)
    mrays, mctx, k2b_inp = wavefront(mesh, mcam)
    words = threefry.split(threefry.fold_in(key, 0), cfg.spp_per_pass)
    k1b_inp = bk.render_inputs(mesh.packed, cam.derive(mcam, 1.0), words, cfg,
                               device=dev)
    state = bk.bounce_step_reference(
        mesh.packed, bk.planar_state(mrays),
        rng.bounce_uniforms(mctx.pixel_id, mctx.base0, mctx.base1, 0), 0, cfg)
    k0b_inp = bk.bounce_inputs(mesh.packed, state, rng.bounce_uniforms(
        mctx.pixel_id, mctx.base0, mctx.base1, 1), 1, cfg)
    runs = {  # name: (entry, kernel function, repetitions, occupancy query args)
        "K2": ("path_kernel<false>", lambda: bk.path_kernel(k2_inp), 20,
               (1, 0, *k2_inp.counts)),
        "K2-BVH": ("path_kernel<true>", lambda: bk.path_kernel(k2b_inp), 4,
                   (1, 1, *k2b_inp.counts)),
        "K1-BVH": ("render_kernel<true>", lambda: bk.render_kernel(k1b_inp), 2,
                   (0, 1, *k1b_inp.counts)),
        "K0-BVH": ("bounce_kernel<true>",
                   lambda: torch.stack(bk.bounce_kernel(k0b_inp)[0]), 10,
                   (2, 1, *k0b_inp.counts)),
    }
    names = list(libs)
    times = {name: {k: [] for k in runs} for name in names}
    outputs = {}
    try:
        for name in (names + names[::-1]) * args.rounds:
            build._LIB = libs[name][0]
            for k, (entry, fn, reps, _) in runs.items():
                outputs.setdefault((name, k), fn())
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                kname = entry.split("<")[0]
                want_bvh = entry.endswith("<true>")
                ms = sum(e.device_time_total for e in prof.key_averages()
                         if kname in e.key and ("<true>" in e.key) == want_bvh)
                times[name][k].append(ms / 1e3 / reps)
    finally:
        build._LIB = main_lib
    result = {"config": "K2: Cornell 512x512 wavefront, 10 bounces; K2-BVH: "
              "published stand-in 512x512 wavefront; K1-BVH: one 16-spp pass "
              "of the mesh benchmark; K0-BVH: its second bounce",
              "card": card_info(), "variants": []}
    for name in names:
        for k in runs:
            if not torch.equal(outputs[(name, k)], outputs[(names[0], k)]):
                raise AssertionError(f"{k} of {name} differs from {names[0]}'s")
        lib, ptxas = libs[name]
        row = {"name": name}
        for k, (entry, _, _, occ_args) in runs.items():
            ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
            err = lib.rtnw_render_occupancy(*occ_args, ctypes.byref(ctas),
                                            ctypes.byref(threads))
            if err != 0:
                raise RuntimeError(f"occupancy query of {name}: {err}")
            row[k] = {"ms": times[name][k], "ptxas": ptxas.get(entry, ""),
                      "ctas_per_sm": ctas.value}
        row["K1 ptxas"] = ptxas.get("render_kernel<false>", "")
        result["variants"].append(row)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
