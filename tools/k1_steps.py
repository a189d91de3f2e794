"""Time K1 (render_kernel<false>) on the headline in each step of its design.

    python3 tools/k1_steps.py [--baseline PATH/render_kernel.cu]

Builds variants of csrc/render_kernel.cu that differ from the shipped
source in one step each, by text substitution:
  - `frame_in_registers`: the 21-float camera frame in a per-thread array
    again instead of shared memory;
  - `threads_64`, `threads_128`: K1's `kRenderThreads`;
  - `min_ctas_N`: `__launch_bounds__(kRenderThreads, N)`, which caps the
    registers a thread so that N CTAs fit on an SM;
  - `regen_N`: `kRegenLanes`, the waiting lanes of a warp at which they
    start new paths (1: each lane at once);
and, with --baseline, another render_kernel.cu as it is (an earlier
commit's, unpacked with `git archive`). Each builds with the package's nvcc
flags (one process per variant, started together) into the package's
gitignored _build/ directory, then serves the package's K1 wrapper in turn:
K1 is timed with CUDA events on the headline's inputs (Cornell 512x512, 128
spp, 10 bounces; the mean of 5 launches after a warm-up), every variant
once in order and once in reverse order. Beside each time: ptxas's
registers and spills, and the CTAs a SM from the kernel's occupancy query
and the waves they give. Every variant's image must equal the shipped
one's bit for bit. Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAME_SMEM = ("  __shared__ float f[21];  // the camera frame, out of the threads' "
              "registers\n"
              "  if (threadIdx.x < 21) f[threadIdx.x] = frame[threadIdx.x];\n")
FRAME_ANCHOR = ("  const Flags fl = decode_flags(flags);\n\n"
                "  const uint32_t p = valid ? (uint32_t)pid_g[i] : 0u;\n")
FRAME_REGS = ("  float f[21];\n#pragma unroll\n"
              "  for (int k = 0; k < 21; ++k) f[k] = frame[k];\n")
THREADS = re.compile(r"constexpr int kRenderThreads = \d+;")
REGEN = re.compile(r"constexpr int kRegenLanes = \d+;")
BOUNDS = "__launch_bounds__(kRenderThreads)"


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"render_kernel.cu: {old[:40]!r} is not there once")
    return src.replace(old, new)


def variant(src: str, name: str) -> str:
    """The shipped source with the one step `name` changed."""
    if name == "shipped":
        return src
    if name == "frame_in_registers":
        src = _sub(src, FRAME_SMEM, "")
        return _sub(src, FRAME_ANCHOR, FRAME_ANCHOR + FRAME_REGS)
    if name.startswith("threads_"):
        if len(THREADS.findall(src)) != 1:
            raise RuntimeError("render_kernel.cu: no single kRenderThreads")
        return THREADS.sub(f"constexpr int kRenderThreads = {name[8:]};", src)
    if name.startswith("regen_"):
        if len(REGEN.findall(src)) != 1:
            raise RuntimeError("render_kernel.cu: no single kRegenLanes")
        return REGEN.sub(f"constexpr int kRegenLanes = {name[6:]};", src)
    if name.startswith("min_ctas_"):
        return _sub(src, BOUNDS, f"__launch_bounds__(kRenderThreads, {name[9:]})")
    raise ValueError(name)


def _build(sources: dict) -> dict:
    """{name: (library path, nvcc output)} of each variant's source."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="k1_steps_"))
    procs = {}
    for name, text in sources.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        lib = tmp / f"lib{name}.so"
        cmd = [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-Xptxas", "-v",
               "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, log)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=pathlib.Path,
                    help="another render_kernel.cu to time as it is")
    ap.add_argument("--variants", default="shipped,frame_in_registers,threads_64,"
                    "regen_1,regen_8,regen_16,min_ctas_6")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_steps: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _event_ms, _ptxas_by_entry
    from raytracingthenextweekcuda_tpu_torch.apps.bench import card_info
    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models import presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops import threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    src = (build.CSRC_DIR / "render_kernel.cu").read_text()
    sources = {name: variant(src, name) for name in args.variants.split(",")}
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    dev = torch.device("cuda", 0)
    main_lib = build.load()
    libs = {}
    for name, (path, log) in _build(sources).items():
        lib = ctypes.CDLL(str(path))
        for fn in ("rtnw_render_samples", "rtnw_render_occupancy", "rtnw_error_string"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = getattr(main_lib, fn).argtypes
                getattr(lib, fn).restype = getattr(main_lib, fn).restype
        ptxas = _ptxas_by_entry(log).get("render_kernel<false>", [])
        libs[name] = (lib, "; ".join(ptxas))

    scene, camera = presets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=512, height=512, spp=128, bounces=10, spp_per_pass=128)
    words = threefry.split(threefry.fold_in(threefry.key(cfg.seed), 0), 128)
    inp = bk.render_inputs(scene.packed, cam.derive(camera, cfg.aspect_ratio), words,
                           cfg, device=dev)
    n = inp.pid.numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = list(libs)
    times = {name: [] for name in names}
    images = {}
    try:
        for name in names + names[::-1]:
            build._LIB = libs[name][0]
            times[name].append(_event_ms(lambda: bk.render_kernel(inp), reps=5))
            images.setdefault(name, bk.render_kernel(inp))
    finally:
        build._LIB = main_lib
    result = {"kernel": "K1 render_kernel<false>",
              "config": "Cornell 512x512, 128 spp, 10 bounces", "card": card_info(),
              "variants": []}
    for name in names:
        if not torch.equal(images[name], images[names[0]]):
            raise AssertionError(f"K1 image of {name} differs from {names[0]}'s")
        lib, ptxas = libs[name]
        row = {"name": name, "ms": times[name], "ptxas": ptxas,
               "ctas_per_sm": None, "threads": None, "waves": None}
        if hasattr(lib, "rtnw_render_occupancy"):
            ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
            err = lib.rtnw_render_occupancy(0, 0, *inp.counts, ctypes.byref(ctas),
                                            ctypes.byref(threads))
            if err != 0:
                raise RuntimeError(f"occupancy query of {name}: {err}")
            row.update(ctas_per_sm=ctas.value, threads=threads.value,
                       waves=-(-n // threads.value) / (ctas.value * sms))
        result["variants"].append(row)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
