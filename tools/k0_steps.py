"""Time K0 (bounce_kernel<false>) in variants that take its time apart.

    python3 tools/k0_steps.py [--baseline OLD/render_kernel.cu] [--variants ...]

On the inputs of chip_smoke.py's K0 row: the full 262,144-ray Cornell
wavefront (512x512, one sample) at its second bounce, with Russian roulette
off and on (`do_rr` 0 and 1). Builds variants of csrc/render_kernel.cu that
differ from the shipped source in one step each, by text substitution:
  - `persistent`: a persistent grid (the CTAs that fit at once, each
    thread taking rays i, i + stride, ...) instead of one ray a thread;
  - `persistent_staged`: the same grid, and each thread's next ray copied
    into shared memory (cp.async, two buffers a CTA) while the current one
    bounces, so that loads overlap bounces;
  - `min_ctas_N`: `__launch_bounds__(kThreads, N)` on the instantiation
    without the walk, which caps its registers so that N CTAs fit on an SM;
  - `copy_only`: the same reads and writes without the bounce (every ray
    passed through as a dead one): the memory floor at this size;
  - `compute_x1`, `compute_x8`: the bounce run 1 or 8 times on each ray's
    loaded inputs (a false dependence keeps the runs apart), the stores
    made conditional on an impossible value: (x8 - x1) / 7 is the bounce's
    own time a launch, with no memory traffic to wait for;
  - `empty`, `empty_scene`: the launch ramp, ceil(n / 128) = 2,048 CTAs
    that return at once, or after the scene rows' copy into shared memory;
  - `f32_functions`: sqrt, 1/sqrt, sin, cos, exp and log in float32 instead
    of the float64 route (not bit-equal; shows that route's share);
  - `scalar_u4`: the uniforms read as four scalar loads from a float
    pointer, as the parent's K0 read them, instead of one float4;
  - `plain_loads`: the carry, alive and uniforms read with plain loads
    instead of `__ldg`;
and, with --baseline, another render_kernel.cu as it is (an earlier
commit's, unpacked with `git archive`: the parent's K0 takes the carry as
one (13, n) buffer and writes a (12, n) one). Each builds with the
package's nvcc flags (tools/k1_steps.py's builder, one process per
variant, started together). Times are device sums from torch.profiler over
repeated launches, every variant once in order and once in reverse order:
L2-warm (back-to-back launches on the same inputs), cold (a 64 MB buffer
zeroed before each launch, beyond the 50 MB L2) and fresh (before each
launch, a copy writes the 13 carry rows the kernel then reads into one
(13, n) buffer, as the parent's wrapper stacked them: every variant and
the baseline read the same just-written bytes, so a difference between
them is their own code's). Checks: the
shipped kernel equals its plain version bit for bit, and so do
`persistent`, `persistent_staged`, `min_ctas_N`,
`scalar_u4` and `plain_loads` and the baseline; a launch on the fresh
copy equals one on the original rows; `copy_only` equals the pass-through; `f32_functions` prints how far it is
off. Beside each: ptxas's registers and spills, CTAs a SM (the occupancy
query counts the scene rows' shared memory, not the staging buffers), and
the bound of chip_smoke.py. Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from k1_steps import _build, _sub  # noqa: E402

BOUNCE = ("  if (r.live)\n"
          "    cont = bounce<kBvh>(s, r.p, r.tm, r.u.x, r.u.y, r.u.z, r.u.w,\n"
          "                        fl.rr && do_rr != 0, fl, tmin, walkers);\n"
          "  if (in) store_step(c, alive_out, i, r.p, cont);\n")
COMPUTE = ("  float acc = 0.0f;\n"
           "#pragma unroll 1\n"
           "  for (int rep = 0; rep < {reps}; ++rep) {{\n"
           "    Path q = r.p;\n"
           "    q.ox = q.ox + acc * 0.0f;  // a false dependence on the last run\n"
           "    if (r.live)\n"
           "      cont = bounce<kBvh>(s, q, r.tm, r.u.x, r.u.y, r.u.z, r.u.w,\n"
           "                          fl.rr && do_rr != 0, fl, tmin, walkers);\n"
           "    acc = acc + q.rx + q.dx;\n"
           "  }}\n"
           "  if (in && acc == -1.5e-38f) store_step(c, alive_out, i, r.p, cont);\n")
AFTER_SCENE = ("  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
               "  if (!kBvh && i >= n) return;\n")
LOAD = "  extern __shared__ float smem[];\n  const Scene s = load_scene("
KERNEL = "// K0: one bounce over the planar carry `c`"
BOUNDS = "__launch_bounds__(kThreads)\nbounce_kernel("
F64 = {
    "return (float)(1.0 / sqrt((double)x));": "return 1.0f / sqrtf(x);",
    "return (float)sin((double)x);": "return sinf(x);",
    "return (float)cos((double)x);": "return cosf(x);",
    "return (float)exp((double)x);": "return expf(x);",
    "return (float)log((double)x);": "return logf(x);",
}
# The persistent loops, run by the instantiation without the walk right
# after the scene rows are in shared memory.
PERSISTENT = """  if constexpr (!kBvh) {
    const Flags fl = decode_flags(flags);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
      StepRay r;
      load_step(c, alive, u4, i, r);
      bool cont = false;
      if (r.live)
        cont = bounce<false>(s, r.p, r.tm, r.u.x, r.u.y, r.u.z, r.u.w,
                             fl.rr && do_rr != 0, fl, tmin, 0u);
      store_step(c, alive_out, i, r.p, cont);
    }
    return;
  }
"""
STAGED = """  if constexpr (!kBvh) {
    const Flags fl = decode_flags(flags);
    float* stage = smem + (use_smem ? (n_floats + 3) & ~3 : 0);
    const int t = threadIdx.x, stride = gridDim.x * kThreads;
    int i = blockIdx.x * kThreads + t;
    if (i < n) stage_step(stage, t, c, alive, u4, i);
    asm volatile("cp.async.commit_group;\\n" ::);
    for (int buf = 0; i < n; i += stride, buf ^= 1) {
      StepRay r;
      asm volatile("cp.async.wait_all;\\n" ::: "memory");
      read_stage(stage + buf * kStageFloats * kThreads, t, r);
      if (i + stride < n)
        stage_step(stage + (buf ^ 1) * kStageFloats * kThreads, t, c, alive, u4,
                   i + stride);
      asm volatile("cp.async.commit_group;\\n" ::);
      bool cont = false;
      if (r.live)
        cont = bounce<false>(s, r.p, r.tm, r.u.x, r.u.y, r.u.z, r.u.w,
                             fl.rr && do_rr != 0, fl, tmin, 0u);
      store_step(c, alive_out, i, r.p, cont);
    }
    return;
  }
"""
# The staging helpers: a thread's slot holds its next ray's 13 carry values
# and alive flag as rows of kThreads words, then its uniforms as a float4.
STAGE_HELPERS = """constexpr int kStageFloats = 18;
constexpr int kStageBytes = 2 * kStageFloats * kThreads * 4;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void stage_step(float* buf, int t, const Carry& c,
                                           const int32_t* alive, const float4* u4,
                                           int i) {
#pragma unroll
  for (int k = 0; k < 13; ++k) cp_async4(buf + k * kThreads + t, c.in[k] + i);
  cp_async4(buf + 13 * kThreads + t, alive + i);
  cp_async16(buf + 14 * kThreads + 4 * t, u4 + i);
}

__device__ __forceinline__ void read_stage(const float* buf, int t, StepRay& r) {
  r.p.ox = buf[t]; r.p.oy = buf[kThreads + t]; r.p.oz = buf[2 * kThreads + t];
  r.p.dx = buf[3 * kThreads + t]; r.p.dy = buf[4 * kThreads + t];
  r.p.dz = buf[5 * kThreads + t];
  r.tm = buf[6 * kThreads + t];
  r.p.tpx = buf[7 * kThreads + t]; r.p.tpy = buf[8 * kThreads + t];
  r.p.tpz = buf[9 * kThreads + t];
  r.p.rx = buf[10 * kThreads + t]; r.p.ry = buf[11 * kThreads + t];
  r.p.rz = buf[12 * kThreads + t];
  r.live = __float_as_int(buf[13 * kThreads + t]) != 0;
  r.u = reinterpret_cast<const float4*>(buf + 14 * kThreads)[t];
}

"""
LAUNCH = ("  const int blocks = (n + kThreads - 1) / kThreads;\n"
          "  const MeshArgs mesh{bvh_b, bvh_m, bvh_c, trih, aos, n_nodes, trih_cols};\n"
          "  auto kernel = n_nodes > 0 ? bounce_kernel<true> : bounce_kernel<false>;\n"
          "  kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(")
# The persistent grid's launch: the CTAs that fit at once, or fewer.
PERSISTENT_LAUNCH = """  const MeshArgs mesh{{bvh_b, bvh_m, bvh_c, trih, aos, n_nodes, trih_cols}};
  auto kernel = n_nodes > 0 ? bounce_kernel<true> : bounce_kernel<false>;
  int blocks = (n + kThreads - 1) / kThreads;
  const size_t launch_bytes = n_nodes > 0 ? bytes : {extra};
  if (n_nodes == 0) {{
    int ctas = 0, sms = 0;
    const int err = residency((const void*)kernel, kThreads, launch_bytes, &ctas, &sms);
    if (err != 0) return err;
    blocks = blocks < (ctas > 0 ? ctas : 1) * sms ? blocks : (ctas > 0 ? ctas : 1) * sms;
  }}
  kernel<<<blocks, kThreads, launch_bytes, (cudaStream_t)stream>>>("""


def variant(src: str, name: str) -> str:
    """The shipped source with the one step `name` changed."""
    if name == "shipped":
        return src
    if name == "persistent":
        src = _sub(src, AFTER_SCENE, PERSISTENT + AFTER_SCENE)
        return _sub(src, LAUNCH, PERSISTENT_LAUNCH.format(extra="bytes"))
    if name == "persistent_staged":
        src = _sub(src, KERNEL, STAGE_HELPERS + KERNEL)
        src = _sub(src, AFTER_SCENE, STAGED + AFTER_SCENE)
        # The scene rows (when staged, rounded to 16 bytes), then the buffers.
        return _sub(src, LAUNCH, PERSISTENT_LAUNCH.format(
            extra="(bytes > 0 ? (size_t)((n_floats + 3) & ~3) * 4 : 0) + kStageBytes"))
    if name.startswith("min_ctas_"):
        return _sub(src, BOUNDS, BOUNDS.replace("(kThreads)",
                                                f"(kThreads, kBvh ? 1 : {name[9:]})"))
    if name == "copy_only":
        return _sub(src, BOUNCE, "  cont = r.live;\n"
                    "  if (in) store_step(c, alive_out, i, r.p, cont);\n")
    if name.startswith("compute_x"):
        return _sub(src, BOUNCE, COMPUTE.format(reps=int(name[9:])))
    if name == "empty":
        at = src.index(AFTER_SCENE)
        start = src.rindex(LOAD, 0, at)
        return src[:start] + "  if (!kBvh) return;\n" + src[start:]
    if name == "empty_scene":
        # Read the staged rows after the barrier, so that the copy stays.
        return _sub(src, AFTER_SCENE, "  if (!kBvh) {\n"
                    "    if (s.sph[0] == -1.5e-38f) alive_out[0] = 7;\n"
                    "    return;\n  }\n" + AFTER_SCENE)
    if name == "scalar_u4":
        src = _sub(src, "const float4* u4, int i, StepRay& r)",
                   "const float* u4, int i, StepRay& r)")
        src = _sub(src, "  r.u = __ldg(u4 + i);\n",
                   "  r.u = make_float4(__ldg(u4 + 4 * i), __ldg(u4 + 4 * i + 1),\n"
                   "                    __ldg(u4 + 4 * i + 2), __ldg(u4 + 4 * i + 3));\n")
        src = _sub(src, "const int32_t* __restrict__ alive, const float4* __restrict__ u4,",
                   "const int32_t* __restrict__ alive, const float* __restrict__ u4,")
        return _sub(src, "(const float4*)u4, n, do_rr", "u4, n, do_rr")
    if name == "plain_loads":
        start = src.index("__device__ __forceinline__ void load_step(")
        end = src.index("__device__ __forceinline__ void store_step(")
        body = src[start:end]
        if body.count("__ldg(") != 15:
            raise RuntimeError("render_kernel.cu: load_step has not 15 __ldg loads")
        return src[:start] + body.replace("__ldg(", "*(") + src[end:]
    if name == "f32_functions":
        for old, new in F64.items():
            src = _sub(src, old, new)
        return src
    raise ValueError(name)


PARENT_ARGS = [ctypes.c_void_p, *[ctypes.c_int] * 5, *[ctypes.c_void_p] * 5,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=pathlib.Path,
                    help="another render_kernel.cu whose K0 takes a (13, n) carry")
    ap.add_argument("--variants", default="shipped,persistent,persistent_staged,"
                    "min_ctas_10,min_ctas_12,copy_only,compute_x1,compute_x8,empty,"
                    "empty_scene,f32_functions,scalar_u4,plain_loads")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k0_steps: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _ptxas_by_entry, _step_bound
    from raytracingthenextweekcuda_tpu_torch.apps.bench import card_info
    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models import presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build, work

    src = (build.CSRC_DIR / "render_kernel.cu").read_text()
    sources = {name: variant(src, name) for name in args.variants.split(",")}
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    dev = torch.device("cuda", 0)
    main_lib = build.load()
    libs = {}
    for name, (path, log) in _build(sources).items():
        lib = ctypes.CDLL(str(path))
        for fn in ("rtnw_bounce_step", "rtnw_render_occupancy", "rtnw_error_string"):
            getattr(lib, fn).argtypes = getattr(main_lib, fn).argtypes
            getattr(lib, fn).restype = getattr(main_lib, fn).restype
        if name == "baseline":
            lib.rtnw_bounce_step.argtypes = PARENT_ARGS
        ptxas = _ptxas_by_entry(log).get("bounce_kernel<false>", [])
        libs[name] = (lib, "; ".join(ptxas))

    scene, camera = presets.cornell_box()
    scene = finalize(scene)
    cfg = RenderConfig(width=512, height=512, spp=1, bounces=10,
                       russian_roulette=True, rr_start_bounce=0)
    rays, ctx = cam.generate_rays(cam.derive(camera, 1.0),
                                  threefry.split(threefry.key(cfg.seed), 1)[0],
                                  512, 512, device=dev)
    state = bk.bounce_step_reference(
        scene.packed, bk.planar_state(rays),
        rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0), 0, cfg)
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 1)
    inputs = {do_rr: bk.bounce_inputs(scene.packed, state, u4, do_rr, cfg)
              for do_rr in (0, 1)}
    n = rays.count
    stacked = torch.stack(inputs[0].carry).contiguous()
    # The fresh condition's buffer: written by a copy before each launch,
    # read as 13 row pointers by the variants and as one (13, n) carry by
    # the baseline.
    fresh_buf = torch.empty((13, n), dtype=torch.float32, device=dev)
    fresh = {do_rr: dataclasses.replace(inp, carry=tuple(fresh_buf.unbind(0)))
             for do_rr, inp in inputs.items()}

    def launch(name, inp, base=None):
        if name != "baseline":
            return bk.bounce_kernel(inp)
        lib = libs[name][0]
        out = torch.empty((12, n), dtype=torch.float32, device=dev)
        alive = torch.empty((n,), dtype=torch.int32, device=dev)
        err = lib.rtnw_bounce_step(
            inp.scene.data_ptr(), *inp.counts, *bk._mesh_args(inp),
            (stacked if base is None else base).data_ptr(), inp.alive.data_ptr(),
            inp.u4.data_ptr(), n,
            int(inp.do_rr), float(inp.tmin), inp.flags, out.data_ptr(),
            alive.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline K0: {lib.rtnw_error_string(err).decode()}")
        return tuple(out.unbind(0)), alive

    flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)

    def device_ms(name, do_rr, mode):
        inp = fresh[do_rr] if mode == "fresh" else inputs[do_rr]
        base = fresh_buf if mode == "fresh" else None
        torch.stack(inputs[do_rr].carry, out=fresh_buf)
        launch(name, inp, base)
        torch.cuda.synchronize()
        reps = args.reps // 2 if mode == "cold" else args.reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if mode == "cold":
                    flush.zero_()
                elif mode == "fresh":
                    torch.stack(inputs[do_rr].carry, out=fresh_buf)
                launch(name, inp, base)
            torch.cuda.synchronize()
        ms = sum(e.device_time_total for e in prof.key_averages()
                 if "bounce_kernel" in e.key and "<true>" not in e.key)
        return ms / 1e3 / reps

    names = list(libs)
    modes = ("warm", "cold", "fresh")
    times = {name: {f"do_rr{r}_{m}": [] for r in (0, 1) for m in modes}
             for name in names}
    outputs = {}
    try:
        for name in names + names[::-1]:
            build._LIB = libs[name][0]
            for do_rr, inp in inputs.items():
                outputs.setdefault((name, do_rr), launch(name, inp))
                torch.stack(inp.carry, out=fresh_buf)
                outputs.setdefault((name, do_rr, "fresh"),
                                   launch(name, fresh[do_rr], fresh_buf))
                for mode in modes:
                    times[name][f"do_rr{do_rr}_{mode}"].append(
                        device_ms(name, do_rr, mode))
    finally:
        build._LIB = main_lib

    def same(a, b):
        return torch.equal(torch.stack(a[0]), torch.stack(b[0])) and torch.equal(a[1],
                                                                                  b[1])

    notes = {}
    for do_rr, inp in inputs.items():
        work.reset()
        plain = bk.bounce_reference(inp)
        if not same(outputs[("shipped", do_rr)], plain):
            raise AssertionError(f"shipped K0 differs from its plain version, do_rr={do_rr}")
        for name in libs:
            if (name.startswith(("persistent", "min_ctas_"))
                    or name in ("baseline", "scalar_u4", "plain_loads")) \
                    and not same(outputs[(name, do_rr)], plain):
                raise AssertionError(f"{name} differs from the plain K0, do_rr={do_rr}")
            if not same(outputs[(name, do_rr, "fresh")], outputs[(name, do_rr)]):
                raise AssertionError(f"{name} on the fresh copy differs, do_rr={do_rr}")
        if "copy_only" in libs:
            rows = (*inp.carry[0:6], *inp.carry[7:13])
            if not same(outputs[("copy_only", do_rr)], (rows, inp.alive)):
                raise AssertionError("copy_only is not the pass-through")
        if "f32_functions" in libs:
            got = outputs[("f32_functions", do_rr)]
            diff = (torch.stack(got[0]) - torch.stack(plain[0])).abs()
            notes[f"f32_functions do_rr{do_rr}"] = {
                "max_abs_diff": float(diff.max()),
                "alive_differ": int((got[1] != plain[1]).sum())}
    work.reset()
    bk.bounce_reference(inputs[1])
    bound = _step_bound(inputs[1], work.WORK)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"kernel": "K0 bounce_kernel<false>",
              "config": "Cornell 512x512 wavefront (262144 rays) at bounce 2, "
                        "Russian roulette from bounce 0",
              "bound_ms": bound[0], "bound_by": bound[1], "card": card_info(),
              "torch": torch.__version__, "notes": notes, "variants": []}
    for name in names:
        lib, ptxas = libs[name]
        ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
        err = lib.rtnw_render_occupancy(2, 0, *inputs[0].counts, ctypes.byref(ctas),
                                        ctypes.byref(threads))
        if err != 0:
            raise RuntimeError(f"occupancy query of {name}: {err}")
        result["variants"].append({"name": name, "ms": times[name], "ptxas": ptxas,
                                   "ctas_per_sm": ctas.value,
                                   "resident_threads": ctas.value * threads.value * sms})
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
