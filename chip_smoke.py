"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or more:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile K1, K2 and K0 (csrc/render_kernel.cu, each with and
     without the tile-BVH walk), K3 (csrc/intersect_kernel.cu) and K4
     (csrc/bvh_winner_kernel.cu) and the work-list kernel
     (csrc/worklist_kernel.cu) with nvcc, one process per source;
     ptxas's registers and spills per kernel, K1 without the walk held at
     K1_REGS registers and K1_SPILL bytes of spills or fewer, beside those
     of K1, K2 and K0 with the walk, and K4's production instantiation at
     K4_REGS and K4_SPILL, beside its stats instantiation, and the
     work-list kernel's; the tile-BVH builder;
  3. K1 vs plain: K1 against its plain torch version on the same CUDA
     tensors, 5 presets at 64x64, 4 spp, 6 bounces, plus Cornell with
     Russian roulette and with the sky off (rtol = atol = 1e-4; smallpt by
     the statistical rule of tests/test_torch_bounce_kernel.py), and a
     small Cornell render on the card against the same render on the CPU;
  4. K1 main path: the headline benchmark (Cornell 512x512, 128 spp, 10
     bounces, one pass) through integrator.render, counting K1's launches
     and checking the image; its render_ms beside fp32_util, the
     reference's op model over the card's FP32 lane rate (fp32_peak_ops,
     read from the card), held in (0, 1.05];
  5. K1 plain time: the plain version at the headline config (32 spp,
     scaled to 128), the mean bounces a path it counted, and K1 against it
     on those same inputs (1e-4);
  6. K3 and K4 vs plain: each kernel against its plain version on the same
     CUDA tensors, bit for bit (codes equal, max |dt| 0), on the primary
     and the bounce-2 wavefronts of both mesh stand-ins, and K3 with
     triangles on a random triangle soup;
  7. mesh card vs CPU: a 32x32 tile-BVH mesh render on the card against
     the same render on the CPU (rtol = atol = 1e-4);
  8. mesh main path: the mesh benchmark (the 960-triangle stand-in,
     512x512, 32 spp, 10 bounces, passes of 16 spp, sorted) through
     integrator.render, counting K3's, K4's and the work-list kernel's
     launches and checking the
     image; then K4's summed device time over one more render's launches
     (torch.profiler);
  9. K3 and K4 times: CUDA events of each kernel on the full-size primary
     and bounce-2 wavefronts beside its plain version's time; K4's
     evaluated (block, leaf) pairs, the mean rays of a block that need the
     leaf (leaf visits over pairs), its chunk box tests and the scanned
     share (the triangles of the entered chunks over the leaves'), with no
     candidate outside an entered chunk; then K4 on the benchmark's mesh
     (`benchmark/configs/mesh_stress`, 84 leaves) primary and bounce-2
     wavefronts, bit for bit against its plain version, its time beside
     its bound, its CTAs a SM and the same work;
 10. K2 and K0 vs plain: K2 against its plain version on the same CUDA
     tensors on the Cornell primary wavefront (512x512, one sample, 10
     bounces, about two rays a lane of its persistent grid) and on the 5
     presets at 64x64, bit for bit; K0 for one bounce with do_rr 0 and 1,
     bit for bit; then
     K0's main path, a wavefront traced by ten bounce_step calls, counting
     K0's launches, against K2 on the same rays (1e-4);
 11. G-buffer main path: render_gbuffer on Cornell (512x512, 8 spp, 10
     bounces, fused), which runs K3 and K2, counting their launches; its
     radiance against render_pass through K1 (1e-4) and its AOVs (hit mask,
     depth, normal norms, wall albedos);
 12. differentiable engine: a fused_bounce=False Cornell render (512x512,
     2 spp, 10 bounces, the torch wavefront over K3) against K1's (1e-4 but
     for at most 1 in 10^4 values, on paths that split at a box edge);
     the gradient of render_gbuffer's depth mean with respect to the
     sphere centres on the card against the CPU's (rtol 1e-3); a backward
     through a fused render raises; run_fit and run_fit_mesh for 10 steps
     at their 96x96, 8 spp configuration, the sphere fit's loss falling;
 13. times: K2 and K0 beside their plain versions (CUDA events, and for
     K0, which runs shorter than its enqueue, the profiler's device time;
     plain: host clock), K1 after the bounce refactor, and on the host clock the
     G-buffer render, the fused_bounce=False render, one fit step and the
     backward of a 512x512, 10-bounce G-buffer with its peak memory;
 14. the tile-BVH walk vs plain: K1, K2 and K0 on the tile-BVH packs of
     both mesh stand-ins (2 and 32 leaves of 768) against their plain
     versions, which walk the tree as one consensus block (128x128,
     Russian roulette on), bit for bit;
 15. the walk's main paths, with the sorted engine turned off as the
     reference's cross-engine check does: the mesh benchmark (published
     stand-in, 512x512, 32 spp, 10 bounces) through integrator.render and
     K1, held against phase 8's sorted image (1e-4 but for at most 1 in
     10^4 values, means at 1e-4), counting K1's launches; a 512x512 G-buffer
     through K2, its radiance against render_pass through K1; ten
     bounce_step calls through K0 against K2 on the same rays; the forced
     render's host time beside a sorted render's, back to back; then the
     three kernels' times beside their plain versions' and their bounds
     (bit for bit against them), and K1-BVH's time and bound on the
     stress stand-in too;
 16. the LBVH regime: the published stand-in unfinalized with an LBVH
     over its mesh (the walk in torch takes the brute-force triangle
     test's place), rendered at 128x128 on the card against the CPU
     (1e-4), the walk's steps, and the gradient of the depth mean with
     respect to a shift of every vertex on the card against the CPU's
     (rtol 1e-3); the walk against the brute-force test on the card on
     primary and random rays (the same hits); the same scene finalized
     (K3 over the pack, the walk merged on top) on the card against the
     CPU (1e-4), counting K3's launches;
 17. scene files through the CLI (`cli.main`): `render --scene
     scenes/cornellbox.yaml` at its defaults (512x512, 32 spp, 10 bounces,
     one K1 launch) and the same file with assets/models/sphere_hi.obj
     added (3,992 triangles, a tile-BVH: 16 spp, K3 and K4 launches), each
     also rendered small on the card against the CPU (1e-4 but for at
     most 1 value in 10^4); `--checkpoint` stopped after its first pass
     and resumed, bit for bit against a straight render on the card;
     `--progressive`, a PNG after every pass;
 18. K4's stats: the instantiation that also writes each block's leaf
     counters [walked, evaluated] against its plain version on phase 6's
     wavefronts (t, codes and counters equal), and its time beside the
     production instantiation's on the published primary wavefront, in
     turns; then mesh metrics 2 and 3 at full size through
     `run_mesh_stress` (the 16,128-triangle stress stand-in, 512x512, 32
     spp, 10 bounces, passes of 16, with the leaf-counter probe) and
     `run_mesh_large` (the 261,120-triangle large stand-in, 512x512, 8 spp,
     5 bounces): their JSON lines, their images, K3's and K4's launches;
 19. tile-sharded rendering on cuda:0: `render_pass_sharded` over 1, 2 and
     4 tiles, bit for bit against `render_pass` on the card, on Cornell
     (K1 over each tile's pixel ids), the published mesh stand-in (the
     sorted wavefront, K3 and K4) and an unfinalized sphere scene (the
     differentiable wavefront); `render --shards 2` through `cli.main`;
     the gradient of a sharded render's mean with respect to an albedo
     against the single-device one (rtol 1e-5); `measure_scaling` on one
     tile;
 20. the live frontend: `live --script "w enter j ] x"` through `cli.main`
     at its defaults (Cornell, 256x256, 5 bounces, one K1 launch a frame):
     the frames' spp readouts (the walk's dirty reset) and the screenshot;
     then `HTTPViewer(port=0)` serving a frame on 127.0.0.1;
 21. the benchmark line: `rtnw-torch bench` at its defaults through
     `cli.main`, one JSON line with the headline, its fp32_util in (0,
     1.05] and the three mesh metrics (mesh_bvh, mesh_stress, mesh_large),
     each with paths_per_sec > 0, counting K1's, K3's and K4's launches
     and K4's stats launches;
 22. the work-list kernel (csrc/worklist_kernel.cu): the exact pass of
     build_worklist against its plain torch loop on the same CUDA inputs
     (counts and order bit for bit, entry equal in value, no leaf hit
     outside an entered group) on the benchmark's mesh
     (`benchmark/configs/mesh_stress`, 84 leaves) primary and bounce-2
     wavefronts and on mesh_large's primary wavefront (496 leaves); on
     each, the kernel's time (CUDA events) beside its bound and the plain
     loop's time (CUDA events), with its registers and spills (ptxas), its
     CTAs a SM and the share of slab tests its group cull keeps.
 23. K1 on the RTiOW final scene (`benchmark/configs/rtiow_final`: 488
     spheres, 385 of them moving, a thin lens of aperture 0.1) at its
     benchmark job, 1200x800, 10 spp, 50 bounces, one pass: K1 against
     its plain version on a seeded 8,192-pixel sample of the film, bit for
     bit; K1's time over the whole film (CUDA events) beside its bound
     (the plain version's bounces on the sample, scaled to the film), its
     registers and spills, its CTAs a SM and the scene bytes each CTA
     stages in shared memory;
 24. the shade kernel (csrc/shade_kernel.cu): the sorted wavefront's
     bounce after K4 (the winners' merge, the hit recompute, the material
     row, the pcg4d draws, the BSDF and the bookkeeping) against its plain
     torch version on the benchmark mesh's primary wavefront (512x512, 16
     samples, 4.19 M rays), bit for bit; its time (CUDA events) beside the
     plain version's and its bytes bound, its registers and spills and its
     CTAs a SM. Phase 2 holds its registers and spills at SHADE_REGS and
     SHADE_SPILL, and phase 8 checks one shade launch a K3 launch.
 25. K4 and the work lists past FRUSTUM_LEAF_THRESHOLD leaves, on the
     materialball_x48 scene (`benchmark/configs/materialball_x48`,
     2,247,192 triangles, 4,336 leaves): one image of its cell's job
     (512x512, 16 spp, 5 bounces) through integrator.render, every work
     list from the work-list kernel (one launch a K4 launch, no frustum
     pair); then on the primary and bounce-2 wavefronts the kernel against
     its plain version on MATERIALBALL_BLOCKS seeded live blocks and the
     longest list (bit for bit, no leaf hit outside an entered group), its
     time beside the frustum pass's and the stored time of the kernel
     before its group cull (UNCULLED_MS, not measured here), its bound
     (its group tests over every live ray), its CTAs a SM and the share of
     slab tests the cull keeps; both lists' mean length a live block and
     the builds' peak memory; K4's winners on the two lists bit for bit, K4
     on the kernel's lists against its plain version on the sampled blocks,
     bit for bit, and K4's times on both lists beside its bound (the
     sample's work scaled to the live blocks) and its walked and evaluated
     positions a live block.

Every kernel's time stands beside its CTAs resident on one SM (its
occupancy query at the launch's shared memory) and the waves its grid
makes on the card's SMs. Then one JSON line with the kernels' numbers
(each with its CTAs a SM, its waves and its bound: the
larger of its bytes over 3.35 TB/s and its float32 operations over 67
TFLOP/s plus its float64 operations over 34 TFLOP/s, for the work this
run's inputs need), the nvidia-smi line, and a last JSON line {"ok": true,
"device": {...}}. Any failure raises and exits non-zero; without a CUDA
device it exits non-zero before printing results.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import tempfile
import time

import numpy as np
import torch

from raytracingthenextweekcuda_tpu_torch.ops.cuda.launch import LAUNCHES


ROOT = pathlib.Path(__file__).resolve().parent
# Appended to scenes/cornellbox.yaml: the repository's 3,968-triangle sphere,
# which takes the scene above the tile-BVH threshold.
SPHERE_HI_ENTRY = """  - mesh: # the 3,968-triangle sphere
      type: 2
      model: sphere_hi.obj
      scale: [0.24, 0.24, 0.24]
      rotate: [0.0, 20.0, 0.0]
      offset: [0.2, 0.25, 0.1]
      materialId: 6
      material: {type: 1, albedo: [1.0, 1.0, 1.0], fuzz: 0.0}
"""


def _event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` runs, after one warmup."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_ms(fn, kernel: str, reps: int) -> float:
    """Mean device milliseconds a launch of the kernels named `kernel`
    (without the tile-BVH walk) over `reps` runs of `fn`, from
    torch.profiler, after one warmup. A trace that holds none of them (the
    card's activity records were once lost this way, in one call of
    several) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if kernel in e.key and "<true>" not in e.key]
        launches = sum(e.count for e in events)
        if launches:
            return sum(e.device_time_total for e in events) / 1e3 / launches
        print(f"[profiler] trace {attempt} of {reps} {kernel} launches holds none "
              f"of them", flush=True)
    raise AssertionError(f"no {kernel} device time in three profiler traces")


def _host_ms(fn) -> tuple[float, object]:
    """Host-clock milliseconds of one run of `fn`, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0, out


def _wavefronts(scene, camera, cfg, samples, dev):
    """The primary and the bounce-2 wavefronts of a tile-BVH scene's first
    pass, as the sorted engine traces them: [(name, rays, alive)]."""
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models import integrator
    from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
    from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene
    from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table
    from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import ray_sort_key

    frame = cam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.fold_in(threefry.key(cfg.seed), 0), samples)
    ds = device_scene(scene, dev)
    rays, ctx = cam.generate_rays_multi(frame, words, cfg.width, cfg.height, dev)
    n = rays.count
    state = (rays, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev))
    out = [("primary", rays, state[3])]
    mats = material_table(scene.materials, dev)
    bounds = torch.from_numpy(scene.packed.bvh_bounds[:, 0].copy()).to(dev)
    for b in (0, 1):
        if b:
            key = ray_sort_key(state[0].origin, state[0].direction, state[3],
                               bounds[0:3], bounds[3:6])
            perm = torch.argsort(key, stable=True)
            state = (state[0].take(perm), state[1][perm], state[2][perm],
                     state[3][perm])
            ctx = rng.RayCtx(ctx.pixel_id[perm], ctx.base0[perm], ctx.base1[perm])
        state = integrator._bounce_body(ds, mats, scene.packed.used_kinds, cfg,
                                        state, ctx, b)
    out.append(("bounce2", state[0], state[3]))
    return ds, out


def _check_equal(name, t_k, c_k, t_p, c_p) -> float:
    """K vs plain bit for bit: codes equal and max |dt| 0. Returns max |dt|."""
    t_k, c_k, t_p, c_p = (x.cpu().numpy() for x in (t_k, c_k, t_p, c_p))
    if not np.array_equal(c_k, c_p):
        bad = int((c_k != c_p).sum())
        raise AssertionError(f"{name}: {bad} of {c_k.size} codes differ")
    err = float(np.abs(t_k.astype(np.float64) - t_p.astype(np.float64)).max())
    if err != 0.0:
        raise AssertionError(f"{name}: max |dt| {err}")
    return err


def _ptxas_by_entry(log: str) -> dict:
    """ptxas -v's register and spill lines, per entry function; a kernel
    templated on the tile-BVH walk is named `name<false>` or `name<true>`."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            # a device function's properties (e.g. the trig slow path) end
            # the entry's lines
            m = re.search(r"\d([a-z_]+_kernel)(ILb([01])E)?E", ln)
            entry = None
            if m:
                entry = m.group(1) + ("" if m.group(2) is None else
                                      "<true>" if m.group(3) == "1" else "<false>")
        elif entry and ("registers" in ln or "spill" in ln):
            out.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    return out


# ptxas's registers and spill bytes of K1 without the tile-BVH walk, and of
# K4's production instantiation (without the stats counters).
K1_REGS = 72
K1_SPILL = 4
K4_REGS = 61
K4_SPILL = 0
# ptxas's registers and spill bytes of the shade kernel.
SHADE_REGS = 64
SHADE_SPILL = 0

# The bounds: the least time the card could take for a kernel's work, the
# larger of its bytes (each input read once, each output written once) over
# the HBM rate and its operations over the peak rate of their type
# (float32 outside the tensor cores, and float64 for the ops/fmath.py
# functions), from NVIDIA's published H100 SXM figures.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
FP64_OPS_S = 34e12
# The work model, counted from the kernels' bodies (adds, multiplies,
# divisions, square roots, min/max, compares and selects; not the logical
# ands): float32 operations of one ray's test against one sphere, plane,
# Havel triangle or quad column (with the update of the best t and its
# column; the tile-BVH walk's leaf loop is the same test), oriented box,
# Möller-Trumbore triangle (K3) and tile-BVH node or leaf box; and an
# estimate of the shading of a path-bounce (BSDF, pcg4d and bookkeeping),
# whose ops/fmath.py functions (a reciprocal square root, a sine and
# cosine pair and a square root) run in float64. The work is what the
# plain versions counted for this run's inputs (ops/cuda/work.py): live
# path-bounces, box tests, and the triangle tests of the leaves the rays
# enter, a leaf's real triangles and not the zero padding of its tile.
SPHERE_OPS = 40
PLANE_OPS = 34
HAVEL_OPS = 41
BOX_OPS = 99
MT_OPS = 54
NODE_OPS = 25
SHADE_OPS = 100
SHADE_F64_OPS = 80
# Per packed type of the bounce kernels: spheres, planes, Havel triangles,
# Havel quads, oriented boxes.
PRIM_OPS = (SPHERE_OPS, PLANE_OPS, HAVEL_OPS, HAVEL_OPS, BOX_OPS)


def _bound(nbytes: float, ops32: float, ops64: float = 0.0) -> tuple:
    """(bound_ms, bound_by) of a kernel's bytes and operations."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops32 / FP32_OPS_S + ops64 / FP64_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _scene_bytes(inp) -> int:
    """The bytes of the bounce kernels' scene inputs: the packed rows and,
    on a tile-BVH pack, the node arrays, the Havel rows and their column
    vectors."""
    extra = ((inp.bvh_bounds, inp.bvh_meta, inp.bvh_count, inp.trih, inp.trih_aos)
             if inp.trih is not None else ())
    return sum(t.numel() * t.element_size() for t in (inp.scene, *extra))


def _bounce_ops(inp, counts: dict, scale: float = 1.0) -> tuple:
    """(float32, float64) operations of the bounce kernels' work as the
    plain versions counted it (ops/cuda/work.py), times `scale`."""
    per = sum(o * c for o, c in zip(PRIM_OPS, inp.counts)) + SHADE_OPS
    ops32 = (counts["bounces"] * per + counts["box_tests"] * NODE_OPS
             + counts["triangle_tests"] * HAVEL_OPS)
    return ops32 * scale, counts["bounces"] * SHADE_F64_OPS * scale


def _k3_bound(rays, alive, rows) -> tuple:
    """K3's bound: each live ray tests every sphere, plane and triangle of
    `rows`; it reads the rays, the alive flags and the rows and writes (t,
    code)."""
    n, live = rays.count, int(alive.sum())
    S, P, T = rows.counts
    nbytes = rows.rows.numel() * 4 + n * (12 + 12 + 4 + 1) + n * 8
    return _bound(nbytes, live * (SPHERE_OPS * S + PLANE_OPS * P + MT_OPS * T))


def _k4_bound(origin, wl, leaves, counts) -> tuple:
    """K4's bound: the live rays' tests of the leaf boxes of their blocks'
    lists, the tests of the chunk boxes of the leaves they enter and the
    triangle tests of the chunks they enter in front of their best t, as
    its plain version counted them; it reads the rays, their ceilings, the
    work lists and the leaves and writes (t, code)."""
    nbytes = (origin.shape[0] * (12 + 12 + 1 + 4 + 8)
              + sum(t.numel() * t.element_size() for t in wl)
              + sum(t.numel() * t.element_size()
                    for t in (leaves.leaf_bounds, leaves.leaf_tiles, leaves.leaf_count,
                              leaves.chunk_bounds, leaves.aos)))
    return _bound(nbytes, counts["chunk_triangle_tests"] * HAVEL_OPS
                  + (counts["box_tests"] + counts["chunk_tests"]) * NODE_OPS)


def _k4_work(label, counts) -> str:
    """K4's work as its plain version counted it, for a phase 9 line."""
    needing = counts["leaf_visits"] / max(counts["block_leaves"], 1)
    share = counts["chunk_triangle_tests"] / max(counts["triangle_tests"], 1)
    if counts["chunk_misses"]:
        raise AssertionError(f"K4 {label}: {counts['chunk_misses']} candidates lie "
                             f"in chunks their rays do not enter")
    return (f"[9 K4 work] {label}: {counts['block_leaves']} (block, leaf) pairs "
            f"evaluated, {counts['leaf_visits']} ray-leaf visits ({needing:.2f} "
            f"needing rays a pair) | {counts['chunk_tests']} chunk box tests "
            f"({counts['chunk_tests'] / max(counts['leaf_visits'], 1):.2f} a visit) | "
            f"{counts['chunk_triangle_tests']} triangle tests in entered chunks of "
            f"{counts['triangle_tests']} in the leaves: scanned share {share:.4f} | "
            f"0 candidates outside entered chunks")


def _render_bound(inp, counts, scale: float = 1.0) -> tuple:
    """K1's bound: the scene, the frame, the key words and the pixel ids in,
    (N, 3) radiance out; the work `counts` holds, times `scale`."""
    n = inp.pid.numel()
    return _bound(_scene_bytes(inp) + 84 + inp.words.numel() * 4 + n * 4 + n * 12,
                  *_bounce_ops(inp, counts, scale))


def _path_bound(inp, counts) -> tuple:
    """K2's bound: the scene and (N,) rays with times and pixel ids in,
    (N, 3) radiance out."""
    n = inp.pid.numel()
    return _bound(_scene_bytes(inp) + n * (12 + 12 + 4 + 4) + n * 12,
                  *_bounce_ops(inp, counts))


def _step_bound(inp, counts) -> tuple:
    """K0's bound: the scene, the (13, N) carry, the alive flags and the
    (N, 4) uniforms in, the (12, N) carry and the alive flags out."""
    n = inp.alive.numel()
    return _bound(_scene_bytes(inp) + n * (13 * 4 + 4 + 16) + n * (12 * 4 + 4),
                  *_bounce_ops(inp, counts))


def _residency(query: str, args: tuple, n: int, persistent: bool = False) -> tuple:
    """(CTAs resident on one SM, waves) of a kernel's launch over `n` rays
    or pixels, one a thread (K4: one 128-ray block a CTA, the same count),
    from the kernel's occupancy query at the launch's shared memory. A
    persistent grid (K2) launches at most one wave and loops over its rays:
    its waves are its CTAs over the resident ones, and its rays a thread
    are a third value."""
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    ctas, threads = build.occupancy(query, *args)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fill = -(-n // threads)
    if persistent:
        grid = min(fill, ctas * sms)
        return ctas, grid / (ctas * sms), n / (grid * threads)
    return ctas, fill / (ctas * sms)


def _res(occ: tuple) -> str:
    rays = f", {occ[2]:.2f} rays a thread" if len(occ) > 2 else ""
    return f"{occ[0]} CTAs a SM, {occ[1]:.2f} waves{rays}"


def _check_same(name, out, plain) -> float:
    """A kernel's output against its plain version's: finite, of the same
    shape, equal bit for bit. Returns max |diff|, 0.0."""
    out, plain = out.cpu().numpy(), plain.cpu().numpy()
    if out.shape != plain.shape or not np.isfinite(out).all():
        raise AssertionError(f"{name}: output not finite or misshapen")
    if not np.array_equal(out, plain):
        diff = np.abs(out.astype(np.float64) - plain.astype(np.float64))
        raise AssertionError(f"{name}: {int((diff > 0).sum())} values differ, "
                             f"max |diff| {float(diff.max())}")
    return 0.0


def _check_close(name, out, plain, smallpt=False) -> float:
    """out vs plain at rtol = atol = 1e-4 (smallpt: under 5% of values off
    by > 0.2, means within 1e-2), finite and of the same shape. Returns
    max |diff|."""
    out, plain = out.cpu().numpy(), plain.cpu().numpy()
    if out.shape != plain.shape or not np.isfinite(out).all():
        raise AssertionError(f"{name}: output not finite or misshapen")
    diff = np.abs(out.astype(np.float64) - plain.astype(np.float64))
    if smallpt:
        frac = float((diff > 0.2).mean())
        if frac >= 0.05:
            raise AssertionError(f"{name}: {frac:.2%} of values off by > 0.2")
        np.testing.assert_allclose(out.mean(), plain.mean(), rtol=1e-2, err_msg=name)
    else:
        np.testing.assert_allclose(out, plain, rtol=1e-4, atol=1e-4, err_msg=name)
    return float(diff.max())


def _check_mesh_image(name, film):
    """A 512x512 render of a mesh stand-in: finite, and the UV sphere dark
    with the floor around it lit. The stand-ins' sphere winds its triangles
    inward, so with back faces culled a camera ray crosses the near side
    and hits the far side from within, and its path stays inside (but for
    the few that slip through a crack between two triangles): the sphere
    renders nearly black, in the reference as here. Returns the centre's
    and the floor's mean rgb."""
    from raytracingthenextweekcuda_tpu_torch.models.film import to_image

    mean = film.mean.cpu().numpy()
    if mean.shape != (512, 512, 3) or not np.isfinite(mean).all():
        raise AssertionError(f"{name}: not finite or misshapen")
    img = to_image(film).astype(np.float64)
    centre = img[226:286, 226:286].reshape(-1, 3).mean(0)
    floor = img[440:500, 40:472].reshape(-1, 3).mean(0)
    if not (centre.max() < 10.0 and floor.min() > 100.0):
        raise AssertionError(f"{name}: centre rgb {centre} (want < 10), "
                             f"floor rgb {floor} (want > 100)")
    return centre, floor


def _check_fp32_util(name, line) -> None:
    """The reference's op model over the card's FP32 lane rate can exceed 1
    only if the peak or the counts are wrong."""
    util = line["fp32_util"]
    if not (util is not None and 0 < util <= 1.05 and line["fp32_peak_ops"] > 0):
        raise AssertionError(f"{name}: fp32_util {util} of fp32_peak_ops "
                             f"{line['fp32_peak_ops']}, want (0, 1.05]")


def _phase21(dev, card) -> None:
    """`rtnw-torch bench` at its defaults through `cli.main`: one line with
    the headline, its fp32_util and the three mesh metrics."""
    import contextlib
    import io

    from raytracingthenextweekcuda_tpu_torch import cli

    out = io.StringIO()
    LAUNCHES["K1"] = LAUNCHES["K3"] = LAUNCHES["K4"] = LAUNCHES["K4-stats"] = 0
    with contextlib.redirect_stdout(out):
        ms, rc = _host_ms(lambda: cli.main(["bench"]))
    launches = (LAUNCHES["K1"], LAUNCHES["K3"], LAUNCHES["K4"],
                LAUNCHES["K4-stats"])
    lines = out.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else {}
    if rc != 0 or min(launches) <= 0:
        raise AssertionError(f"bench: rc {rc}, K1, K3, K4 and K4 stats launches "
                             f"{launches}")
    _check_fp32_util("bench", line)
    for key in ("mesh_bvh", "mesh_stress", "mesh_large"):
        if not line.get(key, {}).get("paths_per_sec", 0) > 0:
            raise AssertionError(f"bench: no {key} paths_per_sec in {sorted(line)}")
    print(f"[21 bench] {json.dumps(line)}", flush=True)
    print(f"[21 bench] `rtnw-torch bench` through cli.main: {ms:.1f} ms host | "
          f"headline render_ms {line['render_ms']:.3f}, fp32_util "
          f"{line['fp32_util']} of fp32_peak_ops {line['fp32_peak_ops']:.6e} | "
          + " | ".join(f"{k} {line[k]['paths_per_sec'] / 1e6:.2f} M paths/s "
                       f"({line[k]['render_ms']:.1f} ms)"
                       for k in ("mesh_bvh", "mesh_stress", "mesh_large"))
          + f" | K1 launches {launches[0]}, K3 {launches[1]}, K4 {launches[2]}, K4 "
          f"stats {launches[3]} | {card}", flush=True)


def _phase18(dev, card, stats_inputs, primary, k4_bound, k4_occ) -> dict:
    """K4's stats instantiation against its plain version and beside the
    production one; mesh metrics 2 and 3. Returns the stats
    instantiation's entry of the kernels line."""
    from raytracingthenextweekcuda_tpu_torch.apps import bench
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4

    for tag, args, leaves in stats_inputs:
        t, c, st = k4.winner(*args, leaves, EPSILON, stats=True)
        tp, cp, stp = k4.winner_reference(*args, leaves, EPSILON, stats=True)
        _check_equal(f"K4 stats {tag}", t, c, tp, cp)
        st, stp = st.cpu(), stp.cpu()
        if not torch.equal(st, stp):
            bad = int((st != stp).any(dim=1).sum())
            raise AssertionError(f"K4 stats {tag}: the counters of {bad} blocks differ")
        t0, c0 = k4.winner(*args, leaves, EPSILON)
        if not (torch.equal(t0, t) and torch.equal(c0, c)):
            raise AssertionError(f"K4 stats {tag}: (t, code) differ from production's")
        live = args[4].counts.cpu() > 0
        print(f"[18 K4 stats vs plain] {tag}: {int(live.sum())} blocks with a list, "
              f"mean listed {float(args[4].counts.cpu()[live].float().mean()):.2f}, "
              f"walked {float(st[live, 0].float().mean()):.2f}, evaluated "
              f"{float(st[live, 1].float().mean()):.2f} | counters equal, (t, code) "
              f"equal to the plain version's and to production's", flush=True)

    # The two instantiations in turns on the published primary wavefront.
    _, _, ds, args = primary
    prod, stat = [], []
    for stats, out in ((False, prod), (True, stat), (True, stat), (False, prod)):
        out.append(_event_ms(lambda: k4.winner(*args, ds.leaves, EPSILON, stats=stats),
                             reps=10))
    stats_plain_ms, _ = _host_ms(lambda: k4.winner_reference(*args, ds.leaves,
                                                             EPSILON, stats=True))
    print(f"[18 K4 stats times] published primary wavefront ({args[0].shape[0]} "
          f"rays): production {prod[0]:.4f}, {prod[1]:.4f} ms | stats {stat[0]:.4f}, "
          f"{stat[1]:.4f} ms (CUDA events, mean of 10, in turns) | plain with stats "
          f"{stats_plain_ms:.1f} ms (host clock) | {card}", flush=True)

    results = {}
    for label, run in (("mesh_stress", bench.run_mesh_stress),
                       ("mesh_large", bench.run_mesh_large)):
        LAUNCHES["K3"] = LAUNCHES["K4"] = LAUNCHES["K4-stats"] = 0
        result = run(device=dev, keep_film=True)
        launches = (LAUNCHES["K3"], LAUNCHES["K4"], LAUNCHES["K4-stats"])
        film = result.pop("film")
        if launches[0] <= 0 or launches[1] <= 0:
            raise AssertionError(f"{label} launched K3 and K4 {launches[:2]} times")
        centre, floor = _check_mesh_image(label, film)
        results[label] = (result, launches)
        print(f"[18 {label}] {json.dumps(result)}", flush=True)
        print(f"[18 {label}] K3 launches {launches[0]}, K4 launches {launches[1]}, "
              f"K4 stats launches {launches[2]} | centre (sphere) rgb "
              f"{centre.round(2).tolist()} floor rgb {floor.round(1).tolist()}",
              flush=True)
    stress, (_, _, stats_launches) = results["mesh_stress"]
    if stats_launches != len(stress["stats"]):
        raise AssertionError(f"the stress probe launched K4's stats instantiation "
                             f"{stats_launches} times for {len(stress['stats'])} bounces")
    large = results["mesh_large"][0]
    if large["frustum"] or results["mesh_large"][1][2]:
        raise AssertionError(f"mesh_large: frustum {large['frustum']} at "
                             f"{large['leaves']} leaves, stats launches "
                             f"{results['mesh_large'][1][2]}")
    return {"name": "K4 bvh_winner_kernel<true> (stats)",
            "source": "bvh_winner_kernel.cu",
            "replaces": "raytracingthenextweekcuda_tpu/ops/pallas/"
                        "bvh_winner_kernel.py:201",
            "launches": stats_launches, "ms": stat[0], "plain_ms": stats_plain_ms,
            "bound": k4_bound, "res": k4_occ}


def _phase19(dev, card) -> None:
    """Tile-sharded rendering on one card: bit for bit against render_pass,
    through the CLI, a gradient, and the scaling measurement."""
    from raytracingthenextweekcuda_tpu_torch import cli
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes
    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.io import image as image_io
    from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize, with_leaves
    from raytracingthenextweekcuda_tpu_torch.ops import threefry
    from raytracingthenextweekcuda_tpu_torch.parallel.mesh import make_mesh
    from raytracingthenextweekcuda_tpu_torch.parallel.multihost import measure_scaling
    from raytracingthenextweekcuda_tpu_torch.parallel.render import render_pass_sharded

    cornell, ccam = presets.cornell_box()
    pub, pcam, _ = bench_scenes.published_mesh_scene()
    sphere, scam = presets.diffuse_sphere_plane()
    cfg = RenderConfig(width=512, height=512, spp=4, bounces=10)
    # (name, scene, camera, config, the kernels its route launches)
    cases = (("cornell", finalize(cornell), ccam, cfg, {"K1"}),
             ("published mesh", finalize(pub), pcam, cfg, {"K3", "K4"}),
             ("sphere-plane wavefront", finalize(sphere), scam,
              dataclasses.replace(cfg, fused_bounce=False), {"K3"}))
    key = threefry.key(5)
    for name, scene, camera, ccfg, uses in cases:
        single = integrator.render_pass(scene, camera, key, ccfg, ccfg.spp, device=dev)
        line = []
        for n in (1, 2, 4):
            LAUNCHES["K1"] = LAUNCHES["K2"] = 0
            LAUNCHES["K3"] = LAUNCHES["K4"] = 0
            ms, out = _host_ms(lambda: render_pass_sharded(
                scene, camera, key, ccfg, ccfg.spp, make_mesh(n, [dev] * n)))
            k1, k2 = LAUNCHES["K1"], LAUNCHES["K2"]
            n3, n4 = LAUNCHES["K3"], LAUNCHES["K4"]
            if (k1 != (n if "K1" in uses else 0) or k2 or (n3 > 0) != ("K3" in uses)
                    or (n4 > 0) != ("K4" in uses)):
                raise AssertionError(f"{name} over {n} tiles launched K1 {k1}, K2 "
                                     f"{k2}, K3 {n3} and K4 {n4} times")
            _check_same(f"{name} over {n} tiles", out, single)
            line.append(f"{n} tiles {ms:.1f} ms (K1 {k1}, K3 {n3}, K4 {n4})")
        print(f"[19 sharded] {name} ({', '.join(sorted(uses))}) {ccfg.width}x{ccfg.height}, "
              f"{ccfg.spp} spp, {ccfg.bounces} bounces on "
              f"{dev}: bit for bit equal to render_pass | " + " | ".join(line)
              + f" | host clock | {card}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/shards.png"
        LAUNCHES["K1"] = 0
        ms, rc = _host_ms(lambda: cli.main(["render", "--shards", "2", "--out", out]))
        img = image_io.read_png(out).astype(np.float64)
        left = img[170:340, 5:40].reshape(-1, 3).mean(0)
        right = img[170:340, -40:-5].reshape(-1, 3).mean(0)
        if (rc != 0 or LAUNCHES["K1"] != 2 or img.shape != (512, 512, 3)
                or not (left[0] > left[2] and right[2] > right[0])):
            raise AssertionError(f"render --shards 2: rc {rc}, K1 launches "
                                 f"{LAUNCHES['K1']}, image {img.shape}, walls "
                                 f"{left} {right}")
    print(f"[19 render --shards 2] cornell 512x512, 32 spp through cli.main: "
          f"{ms:.1f} ms host, K1 launches 2 (one a tile) | left wall rgb "
          f"{left.round(1).tolist()} right wall rgb {right.round(1).tolist()}",
          flush=True)

    gcfg = RenderConfig(width=128, height=128, spp=2, bounces=4, fused_bounce=False)
    albedo = torch.from_numpy(np.asarray(sphere.materials.albedo, np.float32))

    def albedo_grad(render):
        a = torch.tensor(0.7, device=dev, requires_grad=True)
        rows = albedo.to(dev)
        rows = torch.cat([torch.stack([a, rows[0, 1], rows[0, 2]])[None], rows[1:]])
        render(with_leaves(sphere, {"materials.albedo": rows})).mean().backward()
        return float(a.grad)

    g1 = albedo_grad(lambda s: integrator.render_pass(s, scam, key, gcfg, 2,
                                                      device=dev))
    g4 = albedo_grad(lambda s: render_pass_sharded(s, scam, key, gcfg, 2,
                                                   make_mesh(4, [dev] * 4)))
    if g1 == 0.0 or not np.isfinite(g1):
        raise AssertionError(f"albedo gradient {g1}")
    np.testing.assert_allclose(g4, g1, rtol=1e-5)
    rates = measure_scaling(finalize(cornell), ccam,
                            RenderConfig(width=512, height=512, bounces=10),
                            device_counts=[1], verbose=False, devices=[dev])
    if not rates[1] > 0:
        raise AssertionError(f"measure_scaling: {rates}")
    print(f"[19 sharded gradient] d mean(render) / d albedo, sphere-plane 128x128, "
          f"2 spp, 4 bounces: 4 tiles {g4:.8e} vs one device {g1:.8e} (rtol 1e-5) | "
          f"measure_scaling cornell 512x512, 8 spp, 1 tile: {rates[1] / 1e6:.2f} M "
          f"paths/s (host clock) | {card}", flush=True)


def _phase20(dev) -> None:
    """The live frontend through the CLI, and the HTTP viewer."""
    import contextlib
    import io
    import urllib.request

    from raytracingthenextweekcuda_tpu_torch import cli
    from raytracingthenextweekcuda_tpu_torch.apps.viewer import HTTPViewer
    from raytracingthenextweekcuda_tpu_torch.io import image as image_io

    frames = io.StringIO()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the screenshot goes to the working directory
        try:
            LAUNCHES["K1"] = 0
            with contextlib.redirect_stdout(frames):
                ms, rc = _host_ms(lambda: cli.main(["live", "--script",
                                                    "w enter j ] x"]))
            launches = LAUNCHES["K1"]
            shot = pathlib.Path(tmp) / "render_256x256_spp2.png"
            img = image_io.read_png(str(shot)) if shot.exists() else None
        finally:
            os.chdir(cwd)
    spp = [int(v) for v in re.findall(r"spp (\d+)", frames.getvalue())]
    # Two frames at the start and after each command; a move resets the
    # film, the screenshot does not.
    want = [1, 2, 1, 2, 3, 4, 1, 2, 1, 2]
    if rc != 0 or spp != want or launches != len(want) or img is None:
        raise AssertionError(f"live: rc {rc}, spp readouts {spp} (want {want}), K1 "
                             f"launches {launches}, screenshot {img is not None}")
    if img.shape != (256, 256, 3) or not img.any():
        raise AssertionError(f"live screenshot {img.shape}, max {img.max()}")
    viewer = HTTPViewer(port=0)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy
    try:
        viewer.show(img)
        base = f"http://127.0.0.1:{viewer.port}"
        page = opener.open(f"{base}/", timeout=5).read()
        png = opener.open(f"{base}/frame.png", timeout=5).read()
    finally:
        viewer.close()
    if b"frame.png" not in page or not png.startswith(b"\x89PNG"):
        raise AssertionError("HTTPViewer: no page or no PNG frame")
    print(f"[20 live] live --script 'w enter j ] x' through cli.main (cornell "
          f"256x256, 5 bounces): {ms:.1f} ms host, K1 launches {launches}, spp "
          f"readouts {spp}, screenshot render_256x256_spp2.png {img.shape} | "
          f"HTTPViewer on 127.0.0.1:{viewer.port}: page and a {len(png)}-byte PNG "
          f"frame", flush=True)


def _worklist_bound(args, n_leaves, counts) -> tuple:
    """The work-list kernel's bound: its slab tests (NODE_OPS each), the
    live rays' group tests and the leaves of the groups they enter as its
    plain version counts them (`counts`, WORK); it reads the rays, their
    alive flags and ceilings and the leaf boxes once and writes each
    block's count and list."""
    n = args[0].shape[0]
    blocks = n // 128
    nbytes = (n * (12 + 12 + 1 + 4) + 6 * n_leaves * 4
              + blocks * (4 + n_leaves * 8))
    tests = counts["group_tests"] + counts["group_leaf_tests"]
    return _bound(nbytes, tests * NODE_OPS)


def _group_work(o, d, a, tcap, leaves) -> dict:
    """The work-list kernel's group tests and the leaf tests its cull keeps
    over every ray of (o, d, a, tcap), counted as its plain version counts
    them (WORK), from one (rays, groups) slab test without the leaves':
    {"group_tests": ..., "group_leaf_tests": ...}."""
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.wavefront_sort import safe_inv

    gb = leaves.group_bounds
    size = torch.bincount(torch.arange(leaves.n_leaves, device=o.device)
                          // k4.WL_GROUP, minlength=gb.shape[1])
    tests = kept = 0
    step = 1 << 18
    for c0 in range(0, o.shape[0], step):
        live = a[c0: c0 + step, None]
        gn, gf = k4._slab(gb, o[c0: c0 + step, None, :],
                          safe_inv(d[c0: c0 + step])[:, None, :])
        enters = ((gf >= gn) & (gf >= EPSILON) & (gn <= tcap[c0: c0 + step, None])
                  & live)
        tests += int(live.sum()) * gb.shape[1]
        kept += int((enters.to(torch.int64) * size).sum())
    return {"group_tests": tests, "group_leaf_tests": kept}


def _phase22(dev, card, wl_regs) -> dict:
    """The work-list kernel against its plain torch loop on the benchmark's
    mesh wavefronts and on mesh_large's, with times, bounds and residency.
    Returns its entry of the kernels line (the benchmark's primary
    wavefront)."""
    from benchmark import program, scenedata
    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work
    from raytracingthenextweekcuda_tpu_torch.ops.fused import mesh_query

    bench_scene, bench_cam = program.build_scene(scenedata.load_config("mesh_stress"))
    large, large_cam, _ = bench_scenes.large_mesh_scene()
    cases = (("benchmark mesh", finalize(bench_scene), bench_cam,
              RenderConfig(width=512, height=512, spp=32, bounces=10,
                           spp_per_pass=16), 16, ("primary", "bounce2")),
             ("mesh_large", finalize(large), large_cam,
              RenderConfig(width=512, height=512, spp=8, bounces=5,
                           spp_per_pass=8), 8, ("primary",)))
    out = None
    for label, scene, camera, cfg, samples, keep in cases:
        ds, fronts = _wavefronts(scene, camera, cfg, samples, dev)
        L = ds.leaves.n_leaves
        for front, rays, alive in fronts:
            if front not in keep:
                continue
            t, code = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
            alive_mesh, t_cap = mesh_query(ds.leaves, rays, EPSILON, alive, t, code)
            before = LAUNCHES["worklist"]
            args = k4.winner_inputs(rays, ds.leaves, EPSILON, alive_mesh, t_cap)
            if LAUNCHES["worklist"] != before + 1:
                raise AssertionError(f"{label}/{front}: the build launched the "
                                     f"work-list kernel "
                                     f"{LAUNCHES['worklist'] - before} times")
            wl = args[4]
            work.reset()
            plain = k4.worklist_reference(*args[:4], ds.leaves, EPSILON)
            counts = dict(work.WORK)
            if counts["group_misses"]:
                raise AssertionError(f"work-list {label}/{front}: "
                                     f"{counts['group_misses']} leaf hits outside "
                                     f"their entered groups")
            for name in ("counts", "order", "entry"):
                if not torch.equal(getattr(wl, name), getattr(plain, name)):
                    bad = int((getattr(wl, name) != getattr(plain, name)).sum())
                    raise AssertionError(f"work-list kernel {label}/{front}: {bad} "
                                         f"values of {name} differ from the plain "
                                         f"loop's")
            ms = _event_ms(lambda: k4.build_worklist(
                *args[:3], ds.leaves, EPSILON, tcap=args[3]), reps=10)
            plain_ms = _event_ms(lambda: k4.worklist_reference(
                *args[:4], ds.leaves, EPSILON), reps=3)
            bound = _worklist_bound(args, L, counts)
            res = _residency("rtnw_worklist_occupancy", (L,), args[0].shape[0])
            kept = counts["group_leaf_tests"] / max(1, int(args[2].sum()) * L)
            print(f"[22 work-list kernel] {label}/{front}: {rays.count} rays "
                  f"({int(args[2].sum())} to K4), {L} leaves, mean list "
                  f"{float(wl.counts.float().mean()):.2f} | counts and order bit for "
                  f"bit, entry equal | kernel {ms:.4f} ms (CUDA events, mean of 10; "
                  f"{_res(res)}; {wl_regs[0]} registers, {wl_regs[1]} bytes of "
                  f"spills; slab tests kept {kept:.4f}) vs bound {bound[0]:.4f} ms ({bound[1]}) | plain loop "
                  f"{plain_ms:.3f} ms (CUDA events, mean of 3) | {card}", flush=True)
            if out is None:
                out = {"ms": ms, "plain_ms": plain_ms, "bound": bound, "res": res}
    return out


# The most bytes of packed scene rows K1 stages in shared memory a CTA
# (csrc/render_kernel.cu, kSmemLimit); larger scenes are read from global
# memory.
K1_SMEM_LIMIT = 48 * 1024


def _phase23(dev, card, k1_regs) -> None:
    """K1 on the RTiOW final scene at its benchmark job: against its plain
    version on a seeded sample of the film, bit for bit, then its time over
    the whole film beside its bound, registers, residency and staged
    scene bytes."""
    from benchmark import program, scenedata
    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops import threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work

    scene, camera = program.build_scene(scenedata.load_config("rtiow_final"))
    scene = finalize(scene)
    cfg = RenderConfig(width=1200, height=800, spp=10, bounces=50, spp_per_pass=10)
    frame = cam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.fold_in(threefry.key(cfg.seed), 0), cfg.spp)
    inp = bk.render_inputs(scene.packed, frame, words, cfg, device=dev)
    if inp.trih is not None or inp.counts != (488, 0, 0, 0, 0):
        raise AssertionError(f"RTiOW final: K1's inputs hold {inp.counts}, not 488 "
                             f"spheres alone")
    n = inp.pid.numel()
    pixels = np.sort(np.random.default_rng(23).choice(n, 8192, replace=False))
    sub = bk.render_inputs(scene.packed, frame, words, cfg, pixel_ids=pixels,
                           device=dev)
    work.reset()
    _check_same("K1 RTiOW final", bk.render_kernel(sub), bk.render_reference(sub))
    mean_bounces = work.WORK["bounces"] / (pixels.size * cfg.spp)
    bound = _render_bound(inp, work.WORK, n / pixels.size)
    ms = _event_ms(lambda: bk.render_kernel(inp), reps=3)
    res = _residency("rtnw_render_occupancy", (0, 0, *inp.counts), n)
    rows = inp.scene.numel() * inp.scene.element_size()
    staged = rows if rows <= K1_SMEM_LIMIT else 0
    print(f"[23 K1 RTiOW final] 1200x800, 10 spp, 50 bounces, 488 spheres (385 "
          f"moving), aperture 0.1 | K1 vs plain on 8192 pixels: bit for bit | mean "
          f"bounces a path {mean_bounces:.4f} | K1 {ms:.3f} ms (CUDA events, mean "
          f"of 3; {_res(res)}; {k1_regs[0]} registers, {k1_regs[1]} bytes of "
          f"spills; {staged} B of scene rows staged a CTA) vs bound {bound[0]:.3f} "
          f"ms ({bound[1]}) | {card}", flush=True)


def _shade_bound(n: int, tables: int) -> tuple:
    """The shade kernel's bound on a wavefront of `n` live rays: each ray's
    state, both winners and its slot read once (77 bytes) and its new state
    written once (49), the scene's and the materials' rows once; the
    shading of each ray (SHADE_OPS, SHADE_F64_OPS)."""
    return _bound(n * (77 + 49) + tables, n * SHADE_OPS, n * SHADE_F64_OPS)


def _phase24(dev, card, shade_regs) -> dict:
    """The shade kernel against its plain version on the benchmark mesh's
    primary wavefront, bit for bit, with its time beside the plain
    version's, its bound, registers and residency. Returns its entry of
    the kernels line."""
    from benchmark import program, scenedata
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops import rng, threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import shade_kernel as sk
    from raytracingthenextweekcuda_tpu_torch.ops.fused import device_scene, winners
    from raytracingthenextweekcuda_tpu_torch.ops.materials import material_table

    scene, camera = program.build_scene(scenedata.load_config("mesh_stress"))
    scene = finalize(scene)
    cfg = RenderConfig(width=512, height=512, spp=32, bounces=10, spp_per_pass=16)
    words = threefry.split(threefry.fold_in(threefry.key(cfg.seed), 0), 16)
    rays, _ = cam.generate_rays_multi(cam.derive(camera, cfg.aspect_ratio), words,
                                      cfg.width, cfg.height, dev)
    tb0, tb1 = rng.key_bases(words, dev)
    ctx = rng.SlotCtx(None, tb0, tb1, cfg.num_pixels, cfg.num_pixels)
    ds = device_scene(scene, dev)
    mats = material_table(scene.materials, dev)
    n = rays.count
    state = (rays, torch.ones((n, 3), device=dev), torch.zeros((n, 3), device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev))
    slot = torch.arange(n, device=dev)
    win = winners(ds, rays, EPSILON, alive=state[3])
    args = (ds, mats, scene.packed.used_kinds, cfg, state, win, ctx, slot, 0)
    before = LAUNCHES["shade"]
    out = sk.shade(*args)
    if LAUNCHES["shade"] != before + 1:
        raise AssertionError("shade did not launch the shade kernel once")
    plain = sk.shade_reference(*args)
    for name, k, p in (("origin", out[0].origin, plain[0].origin),
                       ("direction", out[0].direction, plain[0].direction),
                       ("throughput", out[1], plain[1]), ("radiance", out[2], plain[2]),
                       ("alive", out[3], plain[3])):
        _check_same(f"shade kernel {name}", k, p)
        if k.is_floating_point() and not torch.equal(k.view(torch.int32),
                                                     p.view(torch.int32)):
            raise AssertionError(f"shade kernel {name}: the sign of a zero differs")
    ms = _event_ms(lambda: sk.shade(*args), reps=20)
    plain_ms = _event_ms(lambda: sk.shade_reference(*args), reps=3)
    tables = sum(t.numel() * t.element_size() for t in (*ds[2:], *mats))
    bound = _shade_bound(n, tables)
    res = _residency("rtnw_shade_occupancy", (), n)
    print(f"[24 shade kernel] benchmark mesh primary wavefront: {n} rays, "
          f"{int(out[3].sum())} live after the bounce | bit for bit against the "
          f"plain version (rays, throughput, radiance, alive) | kernel {ms:.4f} ms "
          f"(CUDA events, mean of 20; {_res(res)}; {shade_regs[0]} registers, "
          f"{shade_regs[1]} bytes of spills) vs bound {bound[0]:.4f} ms ({bound[1]}) "
          f"| plain version {plain_ms:.3f} ms (CUDA events, mean of 3) | {card}",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound": bound, "res": res}


# Live blocks of a materialball wavefront that phase 25 holds K4 and the
# work-list kernel to their plain versions on (the plain walk over a
# bounce-2 list of about 270 leaves takes about a second a block).
MATERIALBALL_BLOCKS = 24
# Stored readings, not measured by this script: the work-list kernel's
# builds of the materialball primary and bounce-2 wavefronts before it had
# its group cull, in ms (CUDA events, mean of 3; NVIDIA H100 80GB HBM3,
# 700 W). No source of that kernel is kept.
UNCULLED_MS = {"primary": 33.21, "bounce2": 15.13}


def _frustum_bound(n: int, n_leaves: int, pairs: int) -> tuple:
    """The frustum pass's bound: one box test (NODE_OPS) of each (block,
    leaf) pair it tests, WORK["frustum_pairs"]; it reads the rays, their
    alive flags and ceilings and the leaf boxes once and writes each
    block's count and (block, leaves) order and entry."""
    blocks = n // 128
    nbytes = n * (12 + 12 + 1 + 4) + 6 * n_leaves * 4 + blocks * (4 + n_leaves * 8)
    return _bound(nbytes, pairs * NODE_OPS)


def _peak_gb(dev, fn) -> tuple:
    """(GB of device memory `fn` peaks at over what was allocated, its
    result)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9, out


def _phase25(dev, card) -> dict:
    """K4 and the work lists past FRUSTUM_LEAF_THRESHOLD leaves: the
    materialball_x48 scene (the cell materialball_x48.offline) rendered
    once through the card's route, the work-list kernel, then on its
    primary and bounce-2 wavefronts the kernel against its plain version
    on a seeded sample of live blocks, its time beside the frustum pass's,
    its bound and the cull's kept share, K4's winners on the kernel's and
    the frustum pass's lists bit for bit, and K4 on the kernel's lists
    against its plain version on the sample, with times, list lengths and
    K4's bound. Returns the primary wavefront's entries of the kernels
    line."""
    from benchmark import program, scenedata
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import integrator
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work
    from raytracingthenextweekcuda_tpu_torch.ops.fused import mesh_query

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scene, camera = program.build_scene(scenedata.load_config("materialball_x48"))
    scene = finalize(scene)
    setup_s = time.perf_counter() - t0
    cfg = RenderConfig(width=512, height=512, spp=16, bounces=5, spp_per_pass=16)
    # The cell's job on the main path: every work list from the kernel.
    for key in ("K4", "worklist"):
        LAUNCHES[key] = 0
    work.reset()
    render_ms, film = _host_ms(lambda: integrator.render(scene, camera, cfg, device=dev))
    k4_launches, wl_launches = LAUNCHES["K4"], LAUNCHES["worklist"]
    pairs = work.WORK["frustum_pairs"]
    ds, fronts = _wavefronts(scene, camera, cfg, 16, dev)
    leaves = ds.leaves
    L = leaves.n_leaves
    mean = film.mean
    if (not k4.use_frustum_worklist(L) or k4.use_frustum_route(L, dev)
            or k4_launches <= 0 or wl_launches != k4_launches or pairs
            or not bool(torch.isfinite(mean).all()) or float(mean.mean()) <= 0.0):
        raise AssertionError(f"materialball_x48 render: {L} leaves, K4 launches "
                             f"{k4_launches}, work-list kernel launches "
                             f"{wl_launches}, frustum pairs {pairs}, mean "
                             f"{float(mean.mean())}")
    print(f"[25 materialball main path] {int((scene.triangles.mesh_id >= 0).sum())} "
          f"triangles, {L} leaves (past the JAX package's frustum line "
          f"{k4.FRUSTUM_LEAF_THRESHOLD}; the card's route builds exact lists at "
          f"any leaf count); scene data and finalize {setup_s:.1f} s | "
          f"one 512x512, 16-spp, 5-bounce image {render_ms:.1f} ms (host clock, "
          f"the first on its shapes), K4 launches {k4_launches}, work-list kernel "
          f"launches {wl_launches}, frustum pairs 0 | {card}", flush=True)

    def rows_of(blocks):
        return (blocks[:, None] * k4.BLOCK
                + torch.arange(k4.BLOCK, device=dev)).flatten()

    out = {}
    lb = leaves.leaf_bounds
    for front, rays, alive in fronts:
        t3, c3 = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
        alive_mesh, t_cap = mesh_query(leaves, rays, EPSILON, alive, t3, c3)
        peak, (o, d, a, tcap, wl) = _peak_gb(dev, lambda: k4.winner_inputs(
            rays, leaves, EPSILON, alive_mesh, t_cap))
        work.reset()
        fr_peak, fr = _peak_gb(dev, lambda: k4.build_worklist(
            o, d, a, lb, EPSILON, tcap=tcap, frustum=True))
        pairs = work.WORK["frustum_pairs"]
        if (pairs != o.shape[0] // k4.BLOCK * L
                or not bool((fr.counts >= wl.counts).all())):
            raise AssertionError(f"materialball {front}: {pairs} frustum pairs, or a "
                                 f"frustum list shorter than the exact one")
        ms = _event_ms(lambda: k4.build_worklist(o, d, a, leaves, EPSILON,
                                                 tcap=tcap), reps=10)
        fr_ms = _event_ms(lambda: k4.build_worklist(o, d, a, lb, EPSILON, tcap=tcap,
                                                    frustum=True), reps=3)
        t_e, c_e = k4.winner(o, d, a, tcap, wl, leaves, EPSILON)
        t_f, c_f = k4.winner(o, d, a, tcap, fr, leaves, EPSILON)
        _check_equal(f"K4 materialball/{front}: frustum vs exact lists", t_f, c_f,
                     t_e, c_e)
        k4e_ms = _event_ms(lambda: k4.winner(o, d, a, tcap, wl, leaves, EPSILON), reps=5)
        k4f_ms = _event_ms(lambda: k4.winner(o, d, a, tcap, fr, leaves, EPSILON), reps=5)
        live = a.view(-1, k4.BLOCK).any(dim=1)
        n_live = int(live.sum())
        _, _, st = k4.winner(o, d, a, tcap, wl, leaves, EPSILON, stats=True)
        st = st[live].float()
        listed = (float(fr.counts[live].float().mean()),
                  float(wl.counts[live].float().mean()))
        del fr

        # The kernel against its plain version on sampled live blocks and
        # the longest list, K4 against its plain version on the sample: a
        # block's list and winners depend on its own rays alone. The
        # kernel's bound counts its group tests over every live ray; K4's
        # scales the sample's work to the live blocks.
        sample = torch.from_numpy(np.sort(np.random.default_rng(25).choice(
            torch.nonzero(live).flatten().cpu().numpy(), MATERIALBALL_BLOCKS,
            replace=False))).to(dev)
        blocks = torch.unique(torch.cat([sample, wl.counts.argmax().view(1)]))
        rows = rows_of(blocks)
        work.reset()
        plain_wl = k4.worklist_reference(o[rows], d[rows], a[rows], tcap[rows],
                                         leaves, EPSILON)
        for name in ("counts", "order", "entry"):
            if not torch.equal(getattr(wl, name)[blocks], getattr(plain_wl, name)):
                raise AssertionError(f"work-list kernel materialball/{front}: {name} "
                                     f"differs from the plain version's on the "
                                     f"sampled blocks")
        if work.WORK["group_misses"]:
            raise AssertionError(f"work-list materialball/{front}: "
                                 f"{work.WORK['group_misses']} leaf hits outside "
                                 f"their entered groups")
        counted = {k: work.WORK[k] for k in ("group_tests", "group_leaf_tests")}
        if _group_work(o[rows], d[rows], a[rows], tcap[rows], leaves) != counted:
            raise AssertionError(f"work-list materialball/{front}: the group count "
                                 f"over the wavefront disagrees with the plain "
                                 f"version's {counted} on its blocks")
        wl_counts = _group_work(o, d, a, tcap, leaves)
        kept = wl_counts["group_leaf_tests"] / max(1, int(a.sum()) * L)
        wl_bound = _worklist_bound((o, d, a), L, wl_counts)
        wl_res = _residency("rtnw_worklist_occupancy", (L,), o.shape[0])
        rows = rows_of(sample)
        sub = k4.WorkList(wl.counts[sample], wl.order[sample], wl.entry[sample])
        work.reset()
        plain_ms, (t_p, c_p) = _host_ms(lambda: k4.winner_reference(
            o[rows], d[rows], a[rows], tcap[rows], sub, leaves, EPSILON))
        _check_equal(f"K4 materialball/{front}: sampled blocks vs plain", t_e[rows],
                     c_e[rows], t_p, c_p)
        scale = n_live / sample.numel()
        counts = {k: v * scale for k, v in work.WORK.items()}
        bound = _k4_bound(o, wl, leaves, counts)
        res = _residency("rtnw_bvh_winner_occupancy", (), o.shape[0])
        fr_bound = _frustum_bound(o.shape[0], L, pairs)
        print(f"[25 materialball {front}] {rays.count} rays, {int(a.sum())} to K4, "
              f"{n_live} live blocks | work-list kernel {ms:.3f} ms (CUDA events, "
              f"mean of 10; {_res(wl_res)}; slab tests kept {kept:.4f}; peak "
              f"{peak:.2f} GB over its inputs) vs bound {wl_bound[0]:.4f} ms "
              f"({wl_bound[1]}; its group tests over every live ray), the kernel "
              f"without the group cull {UNCULLED_MS[front]} ms (a stored reading, "
              f"not measured here), the frustum pass {fr_ms:.3f} ms ({pairs} "
              f"pairs; bound {fr_bound[0]:.4f} ms, {fr_bound[1]}; peak {fr_peak:.2f} "
              f"GB) | lists a live block: frustum {listed[0]:.1f}, exact "
              f"{listed[1]:.1f}, longest {int(wl.counts.max())}; equal to the plain "
              f"version on {blocks.numel()} blocks, the sample and the longest | K4 "
              f"on the exact lists {k4e_ms:.4f} ms, walked {float(st[:, 0].mean()):.1f} evaluated "
              f"{float(st[:, 1].mean()):.1f} a live block ({_res(res)}) vs "
              f"bound {bound[0]:.4f} ms ({bound[1]}; the plain version's work on "
              f"{sample.numel()} sampled blocks x {scale:.1f}); on the frustum "
              f"lists {k4f_ms:.4f} ms (CUDA events, mean of 5) | winners bit for bit "
              f"on the two lists, and against the plain version on the sample "
              f"({plain_ms:.0f} ms, host clock) | {card}", flush=True)
        if work.WORK["chunk_misses"]:
            raise AssertionError(f"K4 materialball/{front}: "
                                 f"{work.WORK['chunk_misses']} candidates outside "
                                 f"entered chunks")
        out.setdefault(front, {"k4_ms": k4e_ms, "k4_bound": bound, "res": res,
                               "launches": k4_launches, "wl_ms": ms,
                               "wl_bound": wl_bound, "wl_res": wl_res,
                               "frustum_ms": fr_ms, "frustum_bound": fr_bound})
    return out["primary"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")

    from raytracingthenextweekcuda_tpu_torch.apps import bench_scenes
    from raytracingthenextweekcuda_tpu_torch.apps.bench import (
        card_info,
        run_bench,
        run_mesh_bench,
    )
    from raytracingthenextweekcuda_tpu_torch.config import EPSILON, RenderConfig
    from raytracingthenextweekcuda_tpu_torch.io.bvh_cache import builder_name
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
    from raytracingthenextweekcuda_tpu_torch.models.film import to_image
    from raytracingthenextweekcuda_tpu_torch.models.scene import SceneBuilder, finalize
    from raytracingthenextweekcuda_tpu_torch.ops import threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bvh_winner_kernel as k4
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import intersect_kernel as k3
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import work
    from raytracingthenextweekcuda_tpu_torch.ops.fused import mesh_query
    from raytracingthenextweekcuda_tpu_torch.ops.rays import Rays

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_info()

    # 1. device
    print(f"[1 device] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load()
    print(f"[2 build] K1, K2, K0, K3, K4 built and loaded in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_SECONDS:.2f} s, one process per source) -> "
          f"{build.library_path().name} | tile-BVH builder: {builder_name()}",
          flush=True)
    ptxas_lines = {}
    for src, log in sorted(build.BUILD_LOGS.items()):
        for entry, ptxas in _ptxas_by_entry(log).items():
            ptxas_lines[entry] = "; ".join(ptxas)
            print(f"[2 build] {src} {entry} ptxas: {ptxas_lines[entry]}", flush=True)
    # K1 without the tile-BVH walk: at most K1_REGS registers and K1_SPILL
    # bytes of spills.
    regs_spills = {}
    for kernel in ("render_kernel", "path_kernel", "bounce_kernel", "bvh_winner_kernel"):
        for entry in (f"{kernel}<false>", f"{kernel}<true>"):
            line = ptxas_lines.get(entry, "")
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            if not (regs and spill):
                raise AssertionError(f"no ptxas registers and spills for {entry}")
            regs_spills[entry] = (int(regs.group(1)), int(spill.group(1)))
    print(f"[2 build] K1 registers, spill bytes: without the tile-BVH walk "
          f"{regs_spills['render_kernel<false>']}, with it "
          f"{regs_spills['render_kernel<true>']} | with the walk: K2 "
          f"{regs_spills['path_kernel<true>']}, K0 "
          f"{regs_spills['bounce_kernel<true>']}", flush=True)
    regs, spill = regs_spills["render_kernel<false>"]
    if regs > K1_REGS or spill > K1_SPILL:
        raise AssertionError(f"K1 without the walk: {regs} registers and {spill} "
                             f"spill bytes, above {K1_REGS} and {K1_SPILL}")
    print(f"[2 build] K4 registers, spill bytes: production "
          f"{regs_spills['bvh_winner_kernel<false>']}, with the stats counters "
          f"{regs_spills['bvh_winner_kernel<true>']}", flush=True)
    wl_line = ptxas_lines.get("worklist_kernel", "")
    regs = re.search(r"Used (\d+) registers", wl_line)
    spill = re.search(r"(\d+) bytes spill stores", wl_line)
    if not (regs and spill):
        raise AssertionError("no ptxas registers and spills for worklist_kernel")
    wl_regs = (int(regs.group(1)), int(spill.group(1)))
    print(f"[2 build] work-list kernel registers, spill bytes: {wl_regs}", flush=True)
    regs, spill = regs_spills["bvh_winner_kernel<false>"]
    if regs > K4_REGS or spill > K4_SPILL:
        raise AssertionError(f"K4's production instantiation: {regs} registers and "
                             f"{spill} spill bytes, above {K4_REGS} and {K4_SPILL}")
    shade_line = ptxas_lines.get("shade_kernel", "")
    regs = re.search(r"Used (\d+) registers", shade_line)
    spill = re.search(r"(\d+) bytes spill stores", shade_line)
    if not (regs and spill):
        raise AssertionError("no ptxas registers and spills for shade_kernel")
    shade_regs = (int(regs.group(1)), int(spill.group(1)))
    print(f"[2 build] shade kernel registers, spill bytes: {shade_regs}", flush=True)
    if shade_regs[0] > SHADE_REGS or shade_regs[1] > SHADE_SPILL:
        raise AssertionError(f"the shade kernel: {shade_regs[0]} registers and "
                             f"{shade_regs[1]} spill bytes, above {SHADE_REGS} and "
                             f"{SHADE_SPILL}")

    # 3. K1 vs plain on the card
    cases = [
        ("sphere_plane", presets.diffuse_sphere_plane, {}),
        ("cornell", presets.cornell_box, {}),
        ("defocus", presets.defocus_blur, {}),
        ("smallpt", presets.smallpt_spheres, {}),
        ("mesh", presets.mesh_showcase, {}),
        ("cornell_rr", presets.cornell_box,
         dict(russian_roulette=True, rr_start_bounce=2)),
        ("cornell_nosky", presets.cornell_box, dict(sky_background=False)),
    ]
    k1_err = 0.0
    for case, preset, extra in cases:
        scene, camera = preset()
        scene = finalize(scene, use_bvh=False)
        cfg = RenderConfig(width=64, height=64, spp=4, bounces=6,
                           spp_per_pass=4, **extra)
        frame = cam.derive(camera, cfg.aspect_ratio)
        words = threefry.split(threefry.key(7), 4)
        inp = bk.render_inputs(scene.packed, frame, words, cfg, device=dev)
        k1 = bk.render_kernel(inp)
        if k1.shape != (cfg.num_pixels, 3):
            raise AssertionError(f"{case}: K1 output {tuple(k1.shape)}")
        smallpt = case == "smallpt"
        err = _check_close(f"K1 {case}", k1, bk.render_reference(inp), smallpt)
        k1_err = max(k1_err, err)
        note = "statistical rule" if smallpt else "rtol=atol=1e-4"
        print(f"[3 K1 vs plain] {case}: max|diff| {err:.3e} ({note}) mean "
              f"{float(k1.mean()):.6f}", flush=True)

    cornell, camera = presets.cornell_box()
    cornell = finalize(cornell)
    small = RenderConfig(width=32, height=32, spp=4, bounces=6, spp_per_pass=2)
    on_card = integrator.render(cornell, camera, small, device=dev).accum.cpu().numpy()
    on_cpu = integrator.render(cornell, camera, small, device="cpu").accum.numpy()
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)
    k1_err = max(k1_err, float(np.abs(on_card - on_cpu).max()))
    print(f"[3 card-vs-cpu] cornell 32x32 render: max|diff| "
          f"{float(np.abs(on_card - on_cpu).max()):.3e}", flush=True)

    # 4. K1 main path
    LAUNCHES["K1"] = 0
    result = run_bench(device=dev, keep_film=True, mesh=False)
    k1_launches = LAUNCHES["K1"]
    film = result.pop("film")
    if k1_launches <= 0:
        raise AssertionError("the headline render did not launch K1")
    _check_fp32_util("headline", result)
    mean = film.mean.cpu().numpy()
    if mean.shape != (512, 512, 3) or not np.isfinite(mean).all():
        raise AssertionError("headline image not finite or misshapen")
    img = to_image(film).astype(np.float64)  # row 0 at the top
    left = img[170:340, 5:40].reshape(-1, 3).mean(0)
    right = img[170:340, -40:-5].reshape(-1, 3).mean(0)
    if not (left[0] > left[2] and right[2] > right[0]):
        raise AssertionError(f"wall colours wrong: left {left}, right {right}")
    print(f"[4 K1 main path] {json.dumps(result)} | K1 launches {k1_launches} | "
          f"left wall rgb {left.round(1).tolist()} right wall rgb "
          f"{right.round(1).tolist()}", flush=True)
    print(f"[4 K1 main path] render_ms {result['render_ms']:.3f} | fp32_util "
          f"{result['fp32_util']} of fp32_peak_ops {result['fp32_peak_ops']:.6e} "
          f"(the reference's op model over SMs x 128 lanes x the maximum SM "
          f"clock) | {card}", flush=True)

    # 5. K1 plain time at the headline config (32 spp, scaled to 128)
    cfg = RenderConfig(width=512, height=512, spp=128, bounces=10, spp_per_pass=128)
    frame = cam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.fold_in(threefry.key(cfg.seed), 0), 128)
    inp = bk.render_inputs(cornell.packed, frame, words, cfg, device=dev)
    k1_ms = _event_ms(lambda: bk.render_kernel(inp), reps=3)
    plain_spp = 32
    sub = bk.render_inputs(cornell.packed, frame, words[:plain_spp], cfg, device=dev)
    work.reset()
    k1_plain_ms, plain = _host_ms(lambda: bk.render_reference(sub))
    k1_plain_ms *= 128 / plain_spp
    k1_bound = _render_bound(inp, work.WORK, 128 / plain_spp)
    mean_bounces = work.WORK["bounces"] / (sub.pid.numel() * plain_spp)
    k1_occ = _residency("rtnw_render_occupancy", (0, 0, *inp.counts), inp.pid.numel())
    head_err = _check_close("K1 headline", bk.render_kernel(sub), plain)
    k1_err = max(k1_err, head_err)
    print(f"[5 K1 plain time] headline config: K1 {k1_ms:.3f} ms (CUDA events, "
          f"mean of 3; {_res(k1_occ)}) | plain {k1_plain_ms:.1f} ms (host clock, "
          f"{plain_spp} spp x{128 // plain_spp} scaled) | mean bounces a path "
          f"{mean_bounces:.4f} of {cfg.bounces} (the plain version's count) | K1 vs "
          f"plain at {plain_spp} spp: max|diff| {head_err:.3e} (rtol=atol=1e-4) | "
          f"{card}", flush=True)

    # 6. K3 and K4 against their plain versions, bit for bit
    mesh_cfg = RenderConfig(width=512, height=512, spp=32, bounces=10,
                            spp_per_pass=16)
    stand_ins = [("published", bench_scenes.published_mesh_scene, 16),
                 ("stress", bench_scenes.stress_mesh_scene, 2)]
    k3_err = k4_err = 0.0
    timing_inputs = None
    stats_inputs = []  # phase 18: (tag, K4's inputs, leaves) of each wavefront
    for label, make, samples in stand_ins:
        scene, mcam, _ = make()
        scene = finalize(scene)
        ds, fronts = _wavefronts(scene, mcam, mesh_cfg, samples, dev)
        for front, rays, alive in fronts:
            tag = f"{label}/{front}"
            t_k, c_k = k3.intersect_packed(rays, ds.analytic, EPSILON, alive=alive)
            t_p, c_p = k3.closest_hit_reference(rays.origin, rays.direction,
                                                rays.time, alive, ds.analytic,
                                                EPSILON)
            k3_err = max(k3_err, _check_equal(f"K3 {tag}", t_k, c_k, t_p, c_p))
            alive_mesh, t_cap = mesh_query(ds.leaves, rays, EPSILON, alive, t_k, c_k)
            args = k4.winner_inputs(rays, ds.leaves, EPSILON, alive_mesh, t_cap)
            t4, c4 = k4.winner(*args, ds.leaves, EPSILON)
            t4p, c4p = k4.winner_reference(*args, ds.leaves, EPSILON)
            k4_err = max(k4_err, _check_equal(f"K4 {tag}", t4, c4, t4p, c4p))
            stats_inputs.append((tag, args, ds.leaves))
            n_live = int(alive.sum())
            wl = args[4]
            print(f"[6 K3/K4 vs plain] {tag}: {rays.count} rays ({n_live} live, "
                  f"{int(alive_mesh.sum())} to K4, {ds.leaves.n_leaves} leaves, "
                  f"mean list {float(wl.counts.float().mean()):.2f}) | K3 codes "
                  f"equal, max|dt| 0 | K4 codes equal, max|dt| 0 | mesh hits "
                  f"{int((c4 >= 0).sum())}", flush=True)
            if label == "published":
                timing_inputs = timing_inputs or {}
                timing_inputs[front] = (rays, alive, ds, args)

    soup = SceneBuilder()
    soup.lambertian(0, (0.5, 0.5, 0.5))
    gen = np.random.default_rng(3)
    for _ in range(64):
        soup.sphere(gen.uniform(-2, 2, 3), float(gen.uniform(0.05, 0.4)), 0)
    for _ in range(8):
        soup.plane(gen.uniform(-2, 2, 3), (0.0, 1.0, 0.0), (1.0, 0.0, 1.0), 2, 0)
    tri = gen.uniform(-2, 2, (3000, 1, 3)) + gen.uniform(-0.3, 0.3, (3000, 3, 3))
    soup.mesh(tri.astype(np.float32), 0)
    soup_scene = finalize(soup.build(), use_bvh=False)
    rows = k3.analytic_rows(soup_scene.packed, dev, include_triangles=True)
    m = 1 << 16
    o = torch.from_numpy(gen.uniform(-3, 3, (m, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(gen.normal(size=(m, 3)).astype(np.float32)).to(dev)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    soup_rays = Rays(o, d, torch.zeros((m,), device=dev))
    alive = torch.from_numpy(gen.random(m) > 0.1).to(dev)
    t_k, c_k = k3.intersect_packed(soup_rays, rows, EPSILON, alive=alive)
    t_p, c_p = k3.closest_hit_reference(o, d, soup_rays.time, alive, rows, EPSILON)
    k3_err = max(k3_err, _check_equal("K3 soup", t_k, c_k, t_p, c_p))
    print(f"[6 K3/K4 vs plain] K3 with triangles on a random soup "
          f"({rows.counts} spheres/planes/triangles, {m} rays): codes equal, "
          f"max|dt| 0, hits {int((c_k >= 0).sum())}", flush=True)

    # 7. a small tile-BVH mesh render on the card against the CPU
    mesh, mcam = presets.mesh_showcase(16, 32)
    mesh = finalize(mesh)
    small = RenderConfig(width=32, height=32, spp=4, bounces=6, spp_per_pass=2)
    on_card = integrator.render(mesh, mcam, small, device=dev).accum.cpu().numpy()
    on_cpu = integrator.render(mesh, mcam, small, device="cpu").accum.numpy()
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)
    mesh_err = float(np.abs(on_card - on_cpu).max())
    k3_err, k4_err = max(k3_err, mesh_err), max(k4_err, mesh_err)
    print(f"[7 mesh card-vs-cpu] mesh_showcase(16, 32) tile-BVH 32x32, 4 spp, "
          f"6 bounces: max|diff| {mesh_err:.3e} (rtol=atol=1e-4)", flush=True)

    # 8. mesh main path
    LAUNCHES["K3"] = 0
    LAUNCHES["K4"] = LAUNCHES["worklist"] = 0
    LAUNCHES["shade"] = 0
    mesh_result = run_mesh_bench(device=dev, keep_film=True)
    k3_launches, k4_launches = LAUNCHES["K3"], LAUNCHES["K4"]
    wl_launches = LAUNCHES["worklist"]
    shade_launches = LAUNCHES["shade"]
    film = mesh_result.pop("film")
    if (k3_launches <= 0 or k4_launches <= 0 or wl_launches != k4_launches
            or shade_launches != k3_launches):
        raise AssertionError(f"the mesh render launched K3 {k3_launches}, K4 "
                             f"{k4_launches}, the work-list kernel "
                             f"{wl_launches} and the shade kernel "
                             f"{shade_launches} times")
    sorted_mesh = film.mean.cpu().numpy()
    centre, floor = _check_mesh_image("mesh image", film)
    print(f"[8 mesh main path] {json.dumps(mesh_result)} | K3 launches "
          f"{k3_launches} K4 launches {k4_launches} work-list launches "
          f"{wl_launches} shade launches {shade_launches} | centre (sphere) rgb "
          f"{centre.round(2).tolist()} floor rgb {floor.round(1).tolist()}",
          flush=True)
    # K4's summed device time over the launches of one mesh render.
    from torch.profiler import ProfilerActivity, profile

    pub, pub_cam, _ = bench_scenes.published_mesh_scene()
    pub = finalize(pub)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        integrator.render(pub, pub_cam, mesh_cfg, device=dev)
        torch.cuda.synchronize()
    k4_events = [e for e in prof.key_averages() if "bvh_winner_kernel" in e.key]
    k4_prof_n = sum(e.count for e in k4_events)
    k4_prof_ms = sum(e.device_time_total for e in k4_events) / 1e3
    print(f"[8 mesh main path] K4 over one render (torch.profiler): "
          + (f"{k4_prof_ms:.3f} ms device in {k4_prof_n} launches, "
             f"{k4_prof_ms / k4_prof_n:.4f} ms a launch" if k4_prof_n and k4_prof_ms
             else "not measured (no K4 device time in the trace)")
          + f" | {card}", flush=True)

    # 9. K3 and K4 device times on the full-size wavefronts
    times, bounds, occ = {}, {}, {}
    for front, (rays, alive, ds, args) in timing_inputs.items():
        k3_ms = _event_ms(lambda: k3.intersect_packed(rays, ds.analytic, EPSILON,
                                                      alive=alive), reps=10)
        k3p_ms, _ = _host_ms(lambda: k3.closest_hit_reference(
            rays.origin, rays.direction, rays.time, alive, ds.analytic, EPSILON))
        k4_ms = _event_ms(lambda: k4.winner(*args, ds.leaves, EPSILON), reps=10)
        work.reset()
        k4p_ms, _ = _host_ms(lambda: k4.winner_reference(*args, ds.leaves, EPSILON))
        wl_ms = _event_ms(lambda: k4.winner_inputs(rays, ds.leaves, EPSILON,
                                                   args[2][:rays.count],
                                                   args[3][:rays.count]), reps=3)
        times[front] = (k3_ms, k3p_ms, k4_ms, k4p_ms)
        bounds[front] = (_k3_bound(rays, alive, ds.analytic),
                         _k4_bound(args[0], args[4], ds.leaves, work.WORK))
        occ[front] = (_residency("rtnw_closest_hit_occupancy", ds.analytic.counts,
                                 rays.count),
                      _residency("rtnw_bvh_winner_occupancy", (), args[0].shape[0]))
        print(f"[9 kernel times] published/{front} ({rays.count} rays): K3 "
              f"{k3_ms:.4f} ms vs plain {k3p_ms:.3f} ms ({_res(occ[front][0])}) | "
              f"K4 {k4_ms:.4f} ms vs plain {k4p_ms:.3f} ms ({_res(occ[front][1])}; "
              f"bound {bounds[front][1][0]:.4f} ms) | work-list build {wl_ms:.3f} ms "
              f"(CUDA events; plain: host clock, one run) | {card}", flush=True)
        print(_k4_work(f"published/{front}", work.WORK), flush=True)
    # K4 on the benchmark's mesh (benchmark/configs/mesh_stress, 84 leaves),
    # bit for bit against its plain version, beside its bound.
    from benchmark import program, scenedata

    bench_scene, bench_cam = program.build_scene(scenedata.load_config("mesh_stress"))
    bds, bench_fronts = _wavefronts(finalize(bench_scene), bench_cam, mesh_cfg, 16, dev)
    for front, rays, alive in bench_fronts:
        t3, c3 = k3.intersect_packed(rays, bds.analytic, EPSILON, alive=alive)
        alive_mesh, t_cap = mesh_query(bds.leaves, rays, EPSILON, alive, t3, c3)
        args = k4.winner_inputs(rays, bds.leaves, EPSILON, alive_mesh, t_cap)
        t4, c4 = k4.winner(*args, bds.leaves, EPSILON)
        work.reset()
        k4p_ms, (t4p, c4p) = _host_ms(lambda: k4.winner_reference(*args, bds.leaves,
                                                                  EPSILON))
        k4_err = max(k4_err, _check_equal(f"K4 benchmark mesh/{front}", t4, c4, t4p,
                                          c4p))
        k4_ms = _event_ms(lambda: k4.winner(*args, bds.leaves, EPSILON), reps=10)
        bm_bound = _k4_bound(args[0], args[4], bds.leaves, work.WORK)
        bm_res = _residency("rtnw_bvh_winner_occupancy", (), args[0].shape[0])
        print(f"[9 kernel times] benchmark mesh/{front} ({rays.count} rays, "
              f"{int(alive_mesh.sum())} to K4, {bds.leaves.n_leaves} leaves): K4 "
              f"{k4_ms:.4f} ms (CUDA events, mean of 10; {_res(bm_res)}) vs bound "
              f"{bm_bound[0]:.4f} ms ({bm_bound[1]}) | plain {k4p_ms:.1f} ms (host clock) | "
              f"codes equal, max|dt| 0 | {card}", flush=True)
        print(_k4_work(f"benchmark mesh/{front}", work.WORK), flush=True)

    # 10. K2 and K0 against their plain versions; K0's main path
    from raytracingthenextweekcuda_tpu_torch.apps import fit
    from raytracingthenextweekcuda_tpu_torch.models.scene import with_leaves
    from raytracingthenextweekcuda_tpu_torch.ops import rng

    head = RenderConfig(width=512, height=512, spp=8, bounces=10, spp_per_pass=8)
    frame = cam.derive(camera, head.aspect_ratio)
    key = threefry.key(head.seed)
    rays, ctx = cam.generate_rays(frame, threefry.split(key, 1)[0], head.width,
                                  head.height, device=dev)
    path_inp = bk.path_inputs(cornell.packed, rays, ctx, head)
    k2_out = bk.path_kernel(path_inp)
    work.reset()
    k2_err = _check_same("K2 cornell 512x512", k2_out, bk.path_reference(path_inp))
    k2_bound = _path_bound(path_inp, work.WORK)
    print(f"[10 K2 vs plain] cornell primary wavefront 512x512, 1 sample, 10 "
          f"bounces: max|diff| {k2_err:.3e} (bit for bit) mean "
          f"{float(k2_out.mean()):.6f}", flush=True)
    for case, preset, _ in cases[:5]:
        scene, pcam = preset()
        scene = finalize(scene, use_bvh=False)
        cfg = RenderConfig(width=64, height=64, spp=1, bounces=10)
        prays, pctx = cam.generate_rays(cam.derive(pcam, 1.0),
                                        threefry.split(threefry.key(7), 1)[0],
                                        64, 64, device=dev)
        err = _check_same(f"K2 {case}", bk.path_trace(scene.packed, prays, pctx, cfg),
                          bk.path_trace_reference(scene.packed, prays, pctx, cfg))
        k2_err = max(k2_err, err)
        print(f"[10 K2 vs plain] {case} 64x64, 10 bounces: max|diff| {err:.3e} "
              f"(bit for bit)", flush=True)

    rr_cfg = dataclasses.replace(head, russian_roulette=True, rr_start_bounce=0)
    state = bk.planar_state(rays)
    state = bk.bounce_step_reference(
        cornell.packed, state,
        rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0), 0, rr_cfg)
    u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 1)
    k0_err = 0.0
    for do_rr in (0, 1):
        k0 = bk.bounce_step(cornell.packed, state, u4, do_rr, rr_cfg)
        plain = bk.bounce_step_reference(cornell.packed, state, u4, do_rr, rr_cfg)
        if not torch.equal(k0[7], plain[7]):
            raise AssertionError(f"K0 do_rr={do_rr}: alive flags differ")
        err = max(_check_same(f"K0 do_rr={do_rr} row {r}", k0[r], plain[r])
                  for r in range(14))
        k0_err = max(k0_err, err)
        print(f"[10 K0 vs plain] cornell 512x512, bounce 2, do_rr={do_rr}: "
              f"alive equal ({int(k0[7].sum())} of {rays.count} go on), "
              f"max|diff| {err:.3e} (bit for bit)", flush=True)
    LAUNCHES["K0"] = 0
    carry = bk.planar_state(rays)
    for b in range(head.bounces):
        carry = bk.bounce_step(cornell.packed, carry,
                               rng.bounce_uniforms(ctx.pixel_id, ctx.base0,
                                                   ctx.base1, b),
                               b >= head.rr_start_bounce, head)
    k0_launches = LAUNCHES["K0"]
    if k0_launches != head.bounces:
        raise AssertionError(f"ten bounce_step calls launched K0 {k0_launches} times")
    err = _check_close("ten K0 steps vs K2", torch.stack(carry[11:14], 1), k2_out)
    k0_err = max(k0_err, err)
    print(f"[10 K0 main path] {head.bounces} bounce_step calls on the 512x512 "
          f"wavefront: K0 launches {k0_launches} | radiance vs K2: max|diff| "
          f"{err:.3e} (rtol=atol=1e-4)", flush=True)

    # 11. G-buffer main path: K3 and K2
    LAUNCHES["K2"] = LAUNCHES["K1"] = LAUNCHES["K3"] = 0
    gbuf = integrator.render_gbuffer(cornell, camera, key, head, head.spp, device=dev)
    k2_launches, k3_gb, k1_gb = LAUNCHES["K2"], LAUNCHES["K3"], LAUNCHES["K1"]
    if k2_launches != head.spp or k3_gb < head.spp or k1_gb:
        raise AssertionError(f"the G-buffer render launched K2 {k2_launches}, "
                             f"K3 {k3_gb} and K1 {k1_gb} times")
    via_k1 = integrator.render_pass(cornell, camera, key, head, head.spp, device=dev)
    err = _check_close("G-buffer radiance vs K1", gbuf["radiance"], via_k1)
    k2_err = max(k2_err, err)
    mask = gbuf["hit_mask"].cpu().numpy()
    depth = gbuf["depth"].cpu().numpy()
    norms = np.linalg.norm(gbuf["normal"].cpu().numpy(), axis=-1)
    albedo = gbuf["albedo"].cpu().numpy()
    left = albedo[170:340, 5:40].reshape(-1, 3).mean(0)
    right = albedo[170:340, -40:-5].reshape(-1, 3).mean(0)
    if not ((mask[64:448, 64:448] == 1.0).all() and (depth[mask > 0] > 0).all()
            and norms.max() <= 1.0 + 1e-4 and left[0] > left[2]
            and right[2] > right[0]):
        raise AssertionError(f"G-buffer AOVs wrong: hit mask min "
                             f"{mask[64:448, 64:448].min()}, depth min "
                             f"{depth[mask > 0].min()}, normal norm max "
                             f"{norms.max()}, albedo left {left} right {right}")
    print(f"[11 G-buffer main path] cornell 512x512, 8 spp, 10 bounces: K2 "
          f"launches {k2_launches} K3 launches {k3_gb} | radiance vs render_pass "
          f"(K1): max|diff| {err:.3e} (rtol=atol=1e-4) | hit mask mean "
          f"{mask.mean():.4f}, depth {depth.min():.4f}..{depth.max():.4f}, normal "
          f"norm max {norms.max():.6f}, albedo left {left.round(3).tolist()} "
          f"right {right.round(3).tolist()}", flush=True)

    # 12. the differentiable engine
    wf_cfg = RenderConfig(width=512, height=512, spp=2, bounces=10,
                          fused_bounce=False)
    LAUNCHES["K2"] = LAUNCHES["K1"] = LAUNCHES["K3"] = 0
    wf_ms, wf_img = _host_ms(lambda: integrator.render_pass(cornell, camera, key,
                                                            wf_cfg, 2, device=dev))
    k3_wf, k12_wf = LAUNCHES["K3"], LAUNCHES["K1"] + LAUNCHES["K2"]
    if k3_wf <= 0 or k12_wf:
        raise AssertionError(f"the wavefront render launched K3 {k3_wf} and "
                             f"K1/K2 {k12_wf} times")
    fused_img = integrator.render_pass(
        cornell, camera, key, dataclasses.replace(wf_cfg, fused_bounce=True), 2,
        device=dev)
    # The two engines intersect different forms of the scene: K1 tests the
    # Cornell cubes as two oriented boxes (slabs), the wavefront as their 24
    # Möller-Trumbore triangles through K3 and the torch recompute, so hit
    # points differ by ulps and a path that grazes a box edge or a plane's
    # extent can split (5 of 524,288 sample paths at this size, traced on
    # the CPU). Values are held at 1e-4 but for at most 1 in 10^4 of them,
    # and the image means at 1e-4.
    wf, k1_img = wf_img.cpu().numpy(), fused_img.cpu().numpy()
    if not np.isfinite(wf).all():
        raise AssertionError("wavefront render not finite")
    off = ~np.isclose(wf, k1_img, rtol=1e-4, atol=1e-4)
    if off.mean() > 1e-4:
        raise AssertionError(f"wavefront vs K1: {int(off.sum())} of {off.size} "
                             f"values apart")
    np.testing.assert_allclose(wf.mean(), k1_img.mean(), rtol=1e-4)
    within = float(np.abs(wf - k1_img)[~off].max())
    print(f"[12 wavefront] cornell fused_bounce=False 512x512, 2 spp, 10 bounces: "
          f"K3 launches {k3_wf} | vs K1: {int(off.sum())} of {off.size} values "
          f"apart by > 1e-4 (split paths; max {float(np.abs(wf - k1_img).max()):.3e}),"
          f" the rest max|diff| {within:.3e}, means {float(wf.mean()):.6f} vs "
          f"{float(k1_img.mean()):.6f} | {wf_ms:.1f} ms host", flush=True)

    def depth_grad(device, size, with_radiance=False):
        c = torch.tensor(np.asarray(cornell.spheres.center0), device=device,
                         requires_grad=True)
        live = with_leaves(cornell, {"spheres.center0": c, "spheres.center1": c})
        cfg = RenderConfig(width=size, height=size, spp=2, bounces=10,
                           fused_bounce=False)
        g = integrator.render_gbuffer(live, camera, key, cfg, 2, device=device)
        loss = g["depth"].mean()
        if with_radiance:
            loss = loss + g["radiance"].mean()
        loss.backward()
        return c.grad

    g_card = depth_grad(dev, 128).cpu().numpy()
    g_cpu = depth_grad(torch.device("cpu"), 128).numpy()
    if not np.isfinite(g_card).all() or np.abs(g_card).max() == 0:
        raise AssertionError(f"depth gradient on the card: {g_card}")
    np.testing.assert_allclose(g_card, g_cpu, rtol=1e-3, atol=1e-6)
    grad_err = float(np.abs(g_card - g_cpu).max())
    print(f"[12 backward] d mean(depth) / d sphere centres, cornell 128x128, 2 "
          f"spp, 10 bounces: card {g_card.tolist()} | vs CPU max|diff| "
          f"{grad_err:.3e} (rtol 1e-3)", flush=True)
    c = torch.tensor(np.asarray(cornell.spheres.center0), device=dev,
                     requires_grad=True)
    live = with_leaves(cornell, {"spheres.center0": c, "spheres.center1": c})
    img = integrator.render_pass(live, camera, key,
                                 RenderConfig(width=64, height=64, spp=1, bounces=3),
                                 1, device=dev)
    try:
        img.sum().backward()
    except NotImplementedError as e:
        if "fused_bounce=False" not in str(e):
            raise
        print(f"[12 backward] through K1 raises: {e}", flush=True)
    else:
        raise AssertionError("a backward through a fused render did not raise")

    with tempfile.TemporaryDirectory() as tmp:
        losses = []
        fit_ms, rc = _host_ms(lambda: fit.run_fit(steps=10, out=f"{tmp}/fit.png",
                                                  device=dev, verbose=False,
                                                  losses=losses))
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"run_fit losses do not fall: {losses}")
        print(f"[12 fit] run_fit 96x96, 8 spp, 4 bounces, 10 steps: loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f} ({fit_ms:.0f} ms host, "
              f"rc {rc} for halving)", flush=True)
        mesh_losses = []
        mfit_ms, rc = _host_ms(lambda: fit.run_fit_mesh(
            steps=10, out=f"{tmp}/fit_mesh.png", device=dev, verbose=False,
            losses=mesh_losses))
        if not np.isfinite(mesh_losses).all():
            raise AssertionError(f"run_fit_mesh losses: {mesh_losses}")
        print(f"[12 fit] run_fit_mesh 96x96, 8 spp, 4 bounces, 10 steps: loss "
              f"{mesh_losses[0]:.5f} -> {mesh_losses[-1]:.5f} ({mfit_ms:.0f} ms "
              f"host, rc {rc} for halving)", flush=True)

    # 13. times
    k2_ms = _event_ms(lambda: bk.path_kernel(path_inp), reps=10)
    k2p_ms, _ = _host_ms(lambda: bk.path_reference(path_inp))
    k0_inp = bk.bounce_inputs(cornell.packed, state, u4, 1, rr_cfg)
    k0_events_ms = _event_ms(lambda: bk.bounce_kernel(k0_inp), reps=10)
    # K0 runs for about 27 µs, less than the host takes to enqueue it, so
    # its events time the host: its own time is the profiler's device time.
    k0_ms = _profiled_ms(lambda: bk.bounce_kernel(k0_inp), "bounce_kernel", 20)
    work.reset()
    k0p_ms, _ = _host_ms(lambda: bk.bounce_reference(k0_inp))
    k0_bound = _step_bound(k0_inp, work.WORK)
    gb_ms, _ = _host_ms(lambda: integrator.render_gbuffer(cornell, camera, key, head,
                                                          head.spp, device=dev))
    fcfg = fit.fit_config(96, 96, 8)
    target = integrator.render_gbuffer(
        fit.make_scene(torch.tensor(fit.TRUE_CENTERS, device=dev),
                       torch.tensor(fit.TRUE_ALBEDOS, device=dev)),
        fit.fit_camera(), key, fcfg, 8, device=dev)
    centers = torch.tensor(fit.INIT_CENTERS, device=dev, requires_grad=True)
    albedos = torch.tensor(fit.INIT_ALBEDOS, device=dev, requires_grad=True)
    step_ms, _ = _host_ms(lambda: fit.fit_loss(centers, albedos, target,
                                               fit.fit_camera(), key, fcfg, 8,
                                               dev).backward())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    bwd_ms, _ = _host_ms(lambda: depth_grad(dev, 512, with_radiance=True))
    peak_gib = (torch.cuda.max_memory_allocated(dev) - base_mem) / 2**30
    k2_occ = _residency("rtnw_render_occupancy", (1, 0, *path_inp.counts),
                        path_inp.pid.numel(), persistent=True)
    k0_occ = _residency("rtnw_render_occupancy", (2, 0, *k0_inp.counts),
                        k0_inp.alive.numel())
    print(f"[13 times] K2 {k2_ms:.4f} ms vs plain {k2p_ms:.1f} ms (cornell "
          f"512x512 primary wavefront, 10 bounces; {_res(k2_occ)}) | K0 "
          f"{k0_ms:.4f} ms device (torch.profiler; CUDA events {k0_events_ms:.4f} ms"
          f", the host's enqueue) vs plain {k0p_ms:.2f} ms (one bounce, 262144 rays; "
          f"{_res(k0_occ)}) | K1 {k1_ms:.3f} ms (headline, phase 5) | CUDA "
          f"events; plain: host clock, one run | {card}", flush=True)
    print(f"[13 times] host clock: G-buffer 512x512, 8 spp, 10 bounces "
          f"{gb_ms:.1f} ms | fused_bounce=False render 512x512, 2 spp, 10 "
          f"bounces {wf_ms:.1f} ms | fit step (96x96, 8 spp, forward and "
          f"backward) {step_ms:.1f} ms | G-buffer 512x512, 2 spp, 10 bounces "
          f"forward and backward {bwd_ms:.1f} ms, peak memory {peak_gib:.3f} GiB "
          f"above the {base_mem / 2**30:.3f} GiB held before | {card}", flush=True)

    # 14. K1, K2 and K0 on tile-BVH packs against their plain versions
    meshes = {}
    bvh_err = dict.fromkeys(("K1", "K2", "K0"), 0.0)
    small = RenderConfig(width=128, height=128, spp=2, bounces=6, spp_per_pass=2,
                         russian_roulette=True, rr_start_bounce=3)
    for label, make, _ in stand_ins:
        scene, mcam, _ = make()
        scene = finalize(scene)
        meshes[label] = (scene, mcam)
        frame = cam.derive(mcam, small.aspect_ratio)
        words = threefry.split(threefry.key(11), small.spp)
        inp = bk.render_inputs(scene.packed, frame, words, small, device=dev)
        e1 = _check_same(f"K1-BVH {label}", bk.render_kernel(inp),
                         bk.render_reference(inp))
        rays, ctx = cam.generate_rays(frame, words[0], small.width, small.height,
                                      device=dev)
        e2 = _check_same(f"K2-BVH {label}",
                         bk.path_trace(scene.packed, rays, ctx, small),
                         bk.path_trace_reference(scene.packed, rays, ctx, small))
        state = bk.bounce_step_reference(
            scene.packed, bk.planar_state(rays),
            rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 0), 0, small)
        u4 = rng.bounce_uniforms(ctx.pixel_id, ctx.base0, ctx.base1, 1)
        e0 = 0.0
        for do_rr in (0, 1):
            k0 = bk.bounce_step(scene.packed, state, u4, do_rr, small)
            plain = bk.bounce_step_reference(scene.packed, state, u4, do_rr, small)
            if not torch.equal(k0[7], plain[7]):
                raise AssertionError(f"K0-BVH {label} do_rr={do_rr}: alive flags differ")
            e0 = max([e0] + [_check_same(f"K0-BVH {label} do_rr={do_rr} row {r}",
                                         k0[r], plain[r]) for r in range(14)])
        for k, e in zip(("K1", "K2", "K0"), (e1, e2, e0)):
            bvh_err[k] = max(bvh_err[k], e)
        print(f"[14 BVH kernels vs plain] {label} stand-in ("
              f"{scene.packed.bvh_bounds.shape[1]} nodes, "
              f"{scene.packed.leaf_tiles.shape[1]} leaves of {inp.leaf_tile}), "
              f"128x128, RR from bounce 3: K1 (2 spp, 6 bounces) max|diff| {e1:.3e}"
              f" | K2 (one sample) {e2:.3e} | K0 (bounce 2, do_rr 0 and 1) "
              f"{e0:.3e} (bit for bit)", flush=True)

    # 15. the main paths of the tile-BVH walk: the mesh benchmark's render
    # through K1 and a G-buffer through K2, with the sorted engine turned
    # off as the reference's cross-engine check does, and ten bounce_step
    # calls through K0
    mesh, mcam = meshes["published"]
    # A sorted render of the same configuration just before the forced one,
    # so that the two host times come from the same moment of the call.
    sorted_ms, _ = _host_ms(lambda: integrator.render(mesh, mcam, mesh_cfg, device=dev))
    sorted_eligible = integrator._sorted_eligible
    integrator._sorted_eligible = lambda *_: False
    try:
        LAUNCHES["K1"] = LAUNCHES["K1-BVH"] = 0
        k1b_render_ms, film = _host_ms(
            lambda: integrator.render(mesh, mcam, mesh_cfg, device=dev))
        k1b_launches = LAUNCHES["K1-BVH"]
        if not k1b_launches == LAUNCHES["K1"] == len(mesh_cfg.passes()):
            raise AssertionError(f"the forced mesh render launched K1 "
                                 f"{LAUNCHES['K1']} times, {k1b_launches} "
                                 "with the walk")
        forced = film.mean.cpu().numpy()
        if not np.isfinite(forced).all():
            raise AssertionError("K1-BVH mesh image not finite")
        off = ~np.isclose(forced, sorted_mesh, rtol=1e-4, atol=1e-4)
        if off.mean() > 1e-4:
            raise AssertionError(f"K1-BVH vs the sorted wavefront: {int(off.sum())} "
                                 f"of {off.size} values apart")
        np.testing.assert_allclose(forced.mean(), sorted_mesh.mean(), rtol=1e-4)
        print(f"[15 K1-BVH main path] published stand-in 512x512, 32 spp, 10 "
              f"bounces, passes of 16, through integrator.render: "
              f"{k1b_render_ms:.1f} ms host, against {sorted_ms:.1f} ms sorted "
              f"just before it (phase 8's bench: {mesh_result['render_ms']:.1f} ms)"
              f" | K1 launches {k1b_launches}, all with the walk | vs the "
              f"sorted wavefront: {int(off.sum())} of {off.size} values apart by "
              f"> 1e-4 (max {float(np.abs(forced - sorted_mesh).max()):.3e}), means"
              f" {float(forced.mean()):.6f} vs {float(sorted_mesh.mean()):.6f} | "
              f"{card}", flush=True)

        gcfg = RenderConfig(width=512, height=512, spp=2, bounces=10)
        LAUNCHES["K2"] = LAUNCHES["K2-BVH"] = LAUNCHES["K1"] = 0
        gbuf = integrator.render_gbuffer(mesh, mcam, key, gcfg, gcfg.spp, device=dev)
        k2b_launches = LAUNCHES["K2-BVH"]
        if not k2b_launches == LAUNCHES["K2"] == gcfg.spp or LAUNCHES["K1"]:
            raise AssertionError(f"the forced mesh G-buffer launched K2 "
                                 f"{LAUNCHES['K2']} times, {k2b_launches} with "
                                 f"the walk, and K1 {LAUNCHES['K1']}")
        via_k1 = integrator.render_pass(mesh, mcam, key, gcfg, gcfg.spp, device=dev)
        err = _check_close("K2-BVH G-buffer radiance vs K1-BVH", gbuf["radiance"],
                           via_k1)
        bvh_err["K2"] = max(bvh_err["K2"], err)
        print(f"[15 K2-BVH main path] forced render_gbuffer, published stand-in "
              f"512x512, 2 spp, 10 bounces: K2 launches {k2b_launches}, all with "
              f"the walk | radiance vs render_pass (K1-BVH): max|diff| {err:.3e} | "
              f"hit mask mean {float(gbuf['hit_mask'].mean()):.4f}", flush=True)
    finally:
        integrator._sorted_eligible = sorted_eligible

    frame = cam.derive(mcam, mesh_cfg.aspect_ratio)
    mrays, mctx = cam.generate_rays(frame, threefry.split(key, 1)[0], 512, 512,
                                    device=dev)
    mpath = bk.path_inputs(mesh.packed, mrays, mctx, head)
    k2b_out = bk.path_kernel(mpath)
    LAUNCHES["K0"] = LAUNCHES["K0-BVH"] = 0
    carry = bk.planar_state(mrays)
    for b in range(head.bounces):
        carry = bk.bounce_step(mesh.packed, carry,
                               rng.bounce_uniforms(mctx.pixel_id, mctx.base0,
                                                   mctx.base1, b),
                               b >= head.rr_start_bounce, head)
    k0b_launches = LAUNCHES["K0-BVH"]
    if not k0b_launches == LAUNCHES["K0"] == head.bounces:
        raise AssertionError(f"ten bounce_step calls on the mesh launched K0 "
                             f"{LAUNCHES['K0']} times, {k0b_launches} with the walk")
    err = _check_close("ten K0-BVH steps vs K2-BVH", torch.stack(carry[11:14], 1),
                       k2b_out)
    bvh_err["K0"] = max(bvh_err["K0"], err)
    print(f"[15 K0-BVH main path] {head.bounces} bounce_step calls on the "
          f"published stand-in's 512x512 wavefront: K0 launches {k0b_launches}, "
          f"all with the walk | radiance vs K2-BVH: max|diff| {err:.3e}", flush=True)

    # The walk's times: K1-BVH over one 16-spp pass of the mesh benchmark
    # (its plain version at 1 spp, scaled), K2-BVH over the 512x512
    # wavefront (10 bounces), K0-BVH over its second bounce.
    pass_spp = mesh_cfg.spp_per_pass
    words = threefry.split(threefry.fold_in(threefry.key(mesh_cfg.seed), 0), pass_spp)
    inp = bk.render_inputs(mesh.packed, frame, words, mesh_cfg, device=dev)
    k1b_ms = _event_ms(lambda: bk.render_kernel(inp), reps=3)
    sub = bk.render_inputs(mesh.packed, frame, words[:1], mesh_cfg, device=dev)
    work.reset()
    k1b_plain_ms, plain = _host_ms(lambda: bk.render_reference(sub))
    k1b_plain_ms *= pass_spp
    k1b_bound = _render_bound(inp, work.WORK, pass_spp)
    work_1spp = dict(work.WORK)
    bvh_err["K1"] = max(bvh_err["K1"], _check_same(
        "K1-BVH 512x512 1 spp", bk.render_kernel(sub), plain))
    k2b_ms = _event_ms(lambda: bk.path_kernel(mpath), reps=5)
    work.reset()
    k2b_plain_ms, plain = _host_ms(lambda: bk.path_reference(mpath))
    k2b_bound = _path_bound(mpath, work.WORK)
    bvh_err["K2"] = max(bvh_err["K2"], _check_same("K2-BVH 512x512", k2b_out, plain))
    state = bk.bounce_step_reference(
        mesh.packed, bk.planar_state(mrays),
        rng.bounce_uniforms(mctx.pixel_id, mctx.base0, mctx.base1, 0), 0, rr_cfg)
    k0b_inp = bk.bounce_inputs(mesh.packed, state,
                               rng.bounce_uniforms(mctx.pixel_id, mctx.base0,
                                                   mctx.base1, 1), 1, rr_cfg)
    k0b_ms = _event_ms(lambda: bk.bounce_kernel(k0b_inp), reps=10)
    work.reset()
    k0b_plain_ms, plain = _host_ms(lambda: bk.bounce_reference(k0b_inp))
    k0b_bound = _step_bound(k0b_inp, work.WORK)
    k0b = bk.bounce_kernel(k0b_inp)
    if not torch.equal(k0b[1], plain[1]):
        raise AssertionError("K0-BVH 512x512: alive flags differ")
    bvh_err["K0"] = max(bvh_err["K0"], _check_same(
        "K0-BVH 512x512", torch.stack(k0b[0]), torch.stack(plain[0])))
    k1b_occ = _residency("rtnw_render_occupancy", (0, 1, *inp.counts),
                         inp.pid.numel())
    k2b_occ = _residency("rtnw_render_occupancy", (1, 1, *mpath.counts),
                         mpath.pid.numel(), persistent=True)
    k0b_occ = _residency("rtnw_render_occupancy", (2, 1, *k0b_inp.counts),
                         k0b_inp.alive.numel())
    print(f"[15 walk times] K1-BVH {k1b_ms:.3f} ms a 16-spp pass ({_res(k1b_occ)})"
          f" vs plain {k1b_plain_ms:.1f} ms (1 spp x16; its work: "
          f"{work_1spp['bounces']} path-bounces, {work_1spp['box_tests']} node "
          f"tests, {work_1spp['leaf_visits']} leaf visits, "
          f"{work_1spp['triangle_tests']} triangle tests) | K2-BVH {k2b_ms:.3f} "
          f"ms ({_res(k2b_occ)}) vs plain {k2b_plain_ms:.1f} ms | K0-BVH "
          f"{k0b_ms:.4f} ms ({_res(k0b_occ)}) vs plain {k0b_plain_ms:.1f} ms | "
          f"CUDA events; plain: host clock, one run | {card}", flush=True)
    print(f"[15 walk bounds] K1-BVH {k1b_bound[0]:.3f} ms ({k1b_bound[1]}) | "
          f"K2-BVH {k2b_bound[0]:.4f} ms ({k2b_bound[1]}) | K0-BVH "
          f"{k0b_bound[0]:.5f} ms ({k0b_bound[1]})", flush=True)
    # K1-BVH on the stress stand-in (32 leaves, a tree with depth): one
    # 16-spp pass of its camera at the mesh benchmark's configuration, its
    # bound from the plain version's work at 1 spp, scaled.
    stress, scam = meshes["stress"]
    sframe = cam.derive(scam, mesh_cfg.aspect_ratio)
    sinp = bk.render_inputs(stress.packed, sframe, words, mesh_cfg, device=dev)
    k1s_ms = _event_ms(lambda: bk.render_kernel(sinp), reps=2)
    ssub = bk.render_inputs(stress.packed, sframe, words[:1], mesh_cfg, device=dev)
    work.reset()
    k1s_plain_ms, plain = _host_ms(lambda: bk.render_reference(ssub))
    k1s_bound = _render_bound(sinp, work.WORK, pass_spp)
    bvh_err["K1"] = max(bvh_err["K1"], _check_same(
        "K1-BVH stress 512x512 1 spp", bk.render_kernel(ssub), plain))
    k1s_occ = _residency("rtnw_render_occupancy", (0, 1, *sinp.counts),
                         sinp.pid.numel())
    print(f"[15 walk times] stress stand-in ({stress.packed.leaf_tiles.shape[1]} "
          f"leaves): K1-BVH {k1s_ms:.3f} ms a 16-spp pass ({_res(k1s_occ)}) vs "
          f"plain {k1s_plain_ms * pass_spp:.1f} ms (1 spp x16; its work: "
          f"{work.WORK['bounces']} path-bounces, {work.WORK['box_tests']} node "
          f"tests, {work.WORK['leaf_visits']} leaf visits, "
          f"{work.WORK['triangle_tests']} triangle tests), bound "
          f"{k1s_bound[0]:.3f} ms ({k1s_bound[1]}); bit for bit at 1 spp | "
          f"{card}", flush=True)

    # 16. the LBVH regime. On an unfinalized scene the LBVH walk takes the
    # place of the brute-force triangle test, so the render and its
    # gradient on the card against the CPU hold the walk itself; then the
    # walk against the brute-force test on the same rays on the card; then
    # the finalized regime, the reference's two-level dispatch, where K3
    # tests the pack (which holds the mesh too) and the walk's hits are
    # merged on top.
    from raytracingthenextweekcuda_tpu_torch.ops import intersect, traverse
    from raytracingthenextweekcuda_tpu_torch.ops.bvh import build_bvh

    raw, lcam, _ = bench_scenes.published_mesh_scene()
    lbvh = build_bvh(raw.triangles)
    lscene = dataclasses.replace(raw, bvh=lbvh)
    lcfg = RenderConfig(width=128, height=128, spp=2, bounces=4, spp_per_pass=2)
    LAUNCHES["K3"] = LAUNCHES["K1"] = LAUNCHES["K2"] = 0
    traverse.STEPS = 0
    lbvh_ms, film = _host_ms(lambda: integrator.render(lscene, lcam, lcfg, device=dev))
    lbvh_steps = traverse.STEPS
    if (lbvh_steps <= 0 or LAUNCHES["K3"] or LAUNCHES["K1"]
            or LAUNCHES["K2"]):
        raise AssertionError(f"the unfinalized LBVH render walked {lbvh_steps} "
                             f"steps and launched K3 {LAUNCHES['K3']}, K1 "
                             f"{LAUNCHES['K1']} and K2 {LAUNCHES['K2']} times")
    on_card = film.accum.cpu().numpy()
    on_cpu = integrator.render(lscene, lcam, lcfg, device="cpu").accum.numpy()
    lbvh_err = _check_close("LBVH render card vs CPU", torch.from_numpy(on_card),
                            torch.from_numpy(on_cpu))

    def lbvh_grad(device):
        dz = torch.zeros((), device=device, requires_grad=True)
        shift = torch.zeros(3, device=device)
        v = (torch.from_numpy(np.asarray(raw.triangles.vertices)).to(device)
             + torch.stack([shift[0], shift[1], dz]))
        g = integrator.render_gbuffer(with_leaves(lscene, {"triangles.vertices": v}),
                                      lcam, key, RenderConfig(width=128, height=128,
                                                              spp=1, bounces=2),
                                      1, device=device)
        g["depth"].mean().backward()
        return float(dz.grad)

    lgrad_ms, g_card = _host_ms(lambda: lbvh_grad(dev))
    g_cpu = lbvh_grad(torch.device("cpu"))
    if not np.isfinite(g_card) or g_card == 0.0:
        raise AssertionError(f"LBVH depth gradient on the card: {g_card}")
    np.testing.assert_allclose(g_card, g_cpu, rtol=1e-3, atol=1e-6)
    print(f"[16 LBVH] published stand-in unfinalized with an LBVH over its "
          f"{raw.triangles.count} triangles (the walk replaces the brute-force "
          f"test), 128x128, 2 spp, 4 bounces: {lbvh_ms:.1f} ms host on the card |"
          f" LBVH walk steps {lbvh_steps}, no kernel launched | card vs CPU "
          f"max|diff| {lbvh_err:.3e} (rtol=atol=1e-4) | d mean(depth) / d vertex "
          f"z (128x128, 1 spp, 2 bounces): card {g_card:.6e} vs CPU {g_cpu:.6e} "
          f"(rtol 1e-3), forward and backward {lgrad_ms:.1f} ms host | {card}",
          flush=True)

    # The walk against the brute-force test on the card: the camera's
    # 256x256 primary rays and rays from random points of the scene's box in
    # random directions. The same triangles hit (valid and material equal),
    # t at rtol 1e-5.
    prays, _ = cam.generate_rays(cam.derive(lcam, 1.0), threefry.split(key, 1)[0],
                                 256, 256, device=dev)
    verts = np.asarray(raw.triangles.vertices, np.float32).reshape(-1, 3)
    gen = np.random.default_rng(5)
    m = 1 << 16
    o = torch.from_numpy(gen.uniform(verts.min(0) - 1.0, verts.max(0) + 1.0,
                                     (m, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(gen.normal(size=(m, 3)).astype(np.float32)).to(dev)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    dev_bvh = lbvh.to(dev)
    walk_hits = 0
    for label, rays in (("primary", prays),
                        ("random", Rays(o, d, torch.zeros((m,), device=dev)))):
        brute = intersect.intersect_triangles(rays, raw.triangles, EPSILON, float("inf"))
        accel = traverse.intersect_bvh(rays, raw.triangles, dev_bvh, EPSILON,
                                       float("inf"))
        valid = brute.valid
        if not (torch.equal(accel.valid, valid)
                and torch.equal(accel.material_id, brute.material_id)):
            raise AssertionError(f"LBVH walk vs brute force, {label} rays: "
                                 f"{int((accel.valid != valid).sum())} hits differ")
        np.testing.assert_allclose(accel.t[valid].cpu().numpy(),
                                   brute.t[valid].cpu().numpy(), rtol=1e-5, atol=1e-6)
        walk_hits += int(valid.sum())
        print(f"[16 LBVH] walk vs brute force on the card, {label} rays "
              f"({rays.count}): the same {int(valid.sum())} hits, t max|diff| "
              f"{float((accel.t - brute.t)[valid].abs().max()):.3e}", flush=True)
    if walk_hits == 0:
        raise AssertionError("LBVH walk vs brute force: no ray hit the mesh")

    fscene = dataclasses.replace(finalize(raw, use_bvh=False), bvh=lbvh)
    LAUNCHES["K3"] = LAUNCHES["K1"] = LAUNCHES["K2"] = 0
    traverse.STEPS = 0
    fin_ms, film = _host_ms(lambda: integrator.render(fscene, lcam, lcfg, device=dev))
    fin_k3, fin_steps = LAUNCHES["K3"], traverse.STEPS
    if fin_k3 <= 0 or fin_steps <= 0 or LAUNCHES["K1"] or LAUNCHES["K2"]:
        raise AssertionError(f"the finalized LBVH render launched K3 {fin_k3} times,"
                             f" K1 {LAUNCHES['K1']}, K2 {LAUNCHES['K2']}, and "
                             f"walked {fin_steps} steps")
    fin_err = _check_close("finalized LBVH render card vs CPU", film.accum.cpu(),
                           integrator.render(fscene, lcam, lcfg, device="cpu").accum)
    print(f"[16 LBVH] the same scene finalized (a brute-force pack, K3 over "
          f"spheres, planes and the mesh, the walk merged on top), 128x128, 2 "
          f"spp, 4 bounces: {fin_ms:.1f} ms host on the card (K3's brute-force "
          f"mesh test included) | K3 launches {fin_k3}, LBVH walk steps "
          f"{fin_steps} | card vs CPU max|diff| {fin_err:.3e} "
          f"(rtol=atol=1e-4) | {card}", flush=True)

    # 17. scene files through the CLI: `render --scene` (K1 on Cornell; K3
    # and K4 on a scene with the 3,968-triangle sphere), each also on the
    # card against the CPU; `--checkpoint` stopped and resumed against a
    # straight render; `--progressive` writes the PNG after every pass.
    from raytracingthenextweekcuda_tpu_torch import cli
    from raytracingthenextweekcuda_tpu_torch.io import image as image_io
    from raytracingthenextweekcuda_tpu_torch.io.yaml_scene import load_scene
    from raytracingthenextweekcuda_tpu_torch.models.checkpoint import load_render_state

    def card_vs_cpu(name, scene, camera, size, spp):
        cfg = RenderConfig(width=size, height=size, spp=spp, bounces=10)
        card = integrator.render(scene, camera, cfg, device=dev).accum.cpu().numpy()
        cpu = integrator.render(scene, camera, cfg, device="cpu").accum.numpy()
        if not np.isfinite(card).all():
            raise AssertionError(f"{name}: the card's render is not finite")
        off = ~np.isclose(card, cpu, rtol=1e-4, atol=1e-4)
        if off.mean() > 1e-4:
            raise AssertionError(f"{name} card vs CPU: {int(off.sum())} of {off.size} "
                                 f"values apart")
        return int(off.sum()), off.size, float(np.abs(card - cpu).max())

    cornell_yaml = str(ROOT / "scenes" / "cornellbox.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/cornell.png"
        LAUNCHES["K1"] = LAUNCHES["K1-BVH"] = LAUNCHES["K3"] = 0
        scene_ms, rc = _host_ms(lambda: cli.main(["render", "--scene", cornell_yaml,
                                                  "--out", out]))
        k1_scene = LAUNCHES["K1"]
        if rc != 0 or k1_scene != 1 or LAUNCHES["K1-BVH"] or LAUNCHES["K3"]:
            raise AssertionError(f"render --scene cornellbox.yaml: rc {rc}, K1 "
                                 f"launches {k1_scene} ({LAUNCHES['K1-BVH']} with "
                                 f"the walk), K3 {LAUNCHES['K3']}")
        img = image_io.read_png(out).astype(np.float64)
        left = img[170:340, 0:40].reshape(-1, 3).mean(0)
        right = img[170:340, -40:].reshape(-1, 3).mean(0)
        if img.shape != (512, 512, 3) or not (left[0] > left[2] and right[2] > right[0]):
            raise AssertionError(f"render --scene cornellbox.yaml: image {img.shape}, "
                                 f"left wall {left}, right wall {right}")
        yscene, ycam = load_scene(cornell_yaml)
        yscene = finalize(yscene)
        off, size, err = card_vs_cpu("cornellbox.yaml 64x64", yscene, ycam, 64, 4)
        k1_err = max(k1_err, err)
        print(f"[17 --scene] render --scene scenes/cornellbox.yaml (512x512, 32 spp, "
              f"10 bounces, one pass) through cli.main: {scene_ms:.1f} ms host, K1 "
              f"launches {k1_scene} | left wall rgb {left.round(1).tolist()} right wall"
              f" rgb {right.round(1).tolist()} | 64x64, 4 spp on the card vs the CPU: "
              f"{off} of {size} values apart by > 1e-4, max|diff| {err:.3e} | {card}",
              flush=True)

        # The Cornell file with the sphere mesh added: 3,992 triangles, so
        # the tile-BVH and the sorted wavefront.
        hi_yaml = f"{tmp}/sphere_hi.yaml"
        with open(hi_yaml, "w") as f:
            f.write(open(cornell_yaml).read() + SPHERE_HI_ENTRY)
        LAUNCHES["K3"] = LAUNCHES["K4"] = LAUNCHES["K1"] = 0
        hi_ms, rc = _host_ms(lambda: cli.main(["render", "--scene", hi_yaml, "--spp",
                                               "16", "--out", f"{tmp}/hi.png"]))
        k3_hi, k4_hi = LAUNCHES["K3"], LAUNCHES["K4"]
        if rc != 0 or k3_hi <= 0 or k4_hi <= 0 or LAUNCHES["K1"]:
            raise AssertionError(f"render --scene with sphere_hi.obj: rc {rc}, K3 "
                                 f"{k3_hi}, K4 {k4_hi}, K1 {LAUNCHES['K1']}")
        hscene, hcam = load_scene(hi_yaml)
        hi_triangles = hscene.triangles.count
        hscene = finalize(hscene)
        off, size, err = card_vs_cpu("sphere_hi 32x32", hscene, hcam, 32, 2)
        k3_err, k4_err = max(k3_err, err), max(k4_err, err)
        print(f"[17 --scene] the same file with assets/models/sphere_hi.obj "
              f"({hi_triangles} triangles in "
              f"{hscene.packed.leaf_tiles.shape[1]} tile-BVH leaves), 512x512, 16 spp, "
              f"10 bounces through cli.main: {hi_ms:.1f} ms host, K3 launches {k3_hi},"
              f" K4 launches {k4_hi} | 32x32, 2 spp on the card vs the CPU: {off} of "
              f"{size} values apart by > 1e-4, max|diff| {err:.3e}", flush=True)

        ck = f"{tmp}/render.npz"
        resume = ["render", "--scene", cornell_yaml, "--spp-per-pass", "8",
                  "--checkpoint", ck, "--out", out]
        if cli.main(resume + ["--spp", "8"]) != 0 or load_render_state(ck)[2] != 1:
            raise AssertionError("--checkpoint: the first pass was not saved")
        LAUNCHES["K1"] = 0
        if cli.main(resume + ["--spp", "16"]) != 0 or LAUNCHES["K1"] != 1:
            raise AssertionError(f"--checkpoint: the resumed render launched K1 "
                                 f"{LAUNCHES['K1']} times (1 pass was left)")
        resumed, _, done = load_render_state(ck, device=dev)
        straight = integrator.render(yscene, ycam, RenderConfig(
            width=512, height=512, spp=16, bounces=10, spp_per_pass=8), device=dev)
        if done != 2 or not torch.equal(resumed.accum, straight.accum):
            raise AssertionError("--checkpoint: the resumed film differs from a "
                                 "straight render")
        writes = []
        write_png = image_io.write_png

        def recorded(path, image):
            write_png(path, image)
            writes.append(os.path.exists(path))

        image_io.write_png = recorded
        try:
            rc = cli.main(["render", "--scene", cornell_yaml, "--spp-per-pass", "8",
                           "--progressive", "--out", f"{tmp}/progressive.png"])
        finally:
            image_io.write_png = write_png
        if rc != 0 or len(writes) != 5 or not all(writes):
            raise AssertionError(f"--progressive: {len(writes)} writes (4 passes and "
                                 f"the last), files there {writes}")
        print(f"[17 --checkpoint] cornellbox.yaml 512x512, 2 passes of 8 spp: stopped "
              f"after pass 1 and resumed (1 K1 launch), the film bit for bit equal to "
              f"a straight render on the card | --progressive: the PNG written after "
              f"each of 4 passes and at the end", flush=True)

    k3_ms, k3p_ms, k4_ms, k4p_ms = times["primary"]
    k3_bound, k4_bound = bounds["primary"]

    # 18-20. K4's stats and mesh metrics 2 and 3; tile-sharded rendering;
    # the live frontend
    k4_stats = _phase18(dev, card, stats_inputs, timing_inputs["primary"],
                        k4_bound, occ["primary"][1])
    del stats_inputs
    _phase19(dev, card)
    _phase20(dev)
    _phase21(dev, card)
    wl = _phase22(dev, card, wl_regs)
    _phase23(dev, card, regs_spills["render_kernel<false>"])
    shade = _phase24(dev, card, shade_regs)
    ball = _phase25(dev, card)
    src = "raytracingthenextweekcuda_tpu_torch/csrc/"
    ref = "raytracingthenextweekcuda_tpu/ops/pallas/"
    walk = f"{ref}bounce_kernel.py:820"  # the consensus walk in _bounce_core

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, res):
        # No single PyTorch call computes any of these functions: no
        # library time.
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None, "ctas_per_sm": res[0],
                "waves": res[1]}

    print(json.dumps({"kernels": [
        entry("K1 render_kernel", "render_kernel.cu", f"{ref}bounce_kernel.py:1466",
              k1_launches, k1_err, k1_ms, k1_plain_ms, k1_bound, k1_occ),
        entry("K1-BVH render_kernel<true>", "render_kernel.cu", walk, k1b_launches,
              bvh_err["K1"], k1b_ms, k1b_plain_ms, k1b_bound, k1b_occ),
        entry("K2 path_kernel", "render_kernel.cu", f"{ref}bounce_kernel.py:1392",
              k2_launches, k2_err, k2_ms, k2p_ms, k2_bound, k2_occ),
        entry("K2-BVH path_kernel<true>", "render_kernel.cu", walk, k2b_launches,
              bvh_err["K2"], k2b_ms, k2b_plain_ms, k2b_bound, k2b_occ),
        entry("K0 bounce_kernel", "render_kernel.cu", f"{ref}bounce_kernel.py:1303",
              k0_launches, k0_err, k0_ms, k0p_ms, k0_bound, k0_occ),
        entry("K0-BVH bounce_kernel<true>", "render_kernel.cu", walk, k0b_launches,
              bvh_err["K0"], k0b_ms, k0b_plain_ms, k0b_bound, k0b_occ),
        entry("K3 closest_hit_kernel", "intersect_kernel.cu",
              f"{ref}intersect_kernel.py:443", k3_launches, k3_err, k3_ms, k3p_ms,
              k3_bound, occ["primary"][0]),
        entry("K4 bvh_winner_kernel", "bvh_winner_kernel.cu",
              f"{ref}bvh_winner_kernel.py:201", k4_launches, k4_err, k4_ms, k4p_ms,
              k4_bound, occ["primary"][1]),
        entry(k4_stats["name"], k4_stats["source"], k4_stats["replaces"],
              k4_stats["launches"], 0.0, k4_stats["ms"], k4_stats["plain_ms"],
              k4_stats["bound"], k4_stats["res"]),
        entry("work-list worklist_kernel", "worklist_kernel.cu",
              f"none (XLA ops: {ref}bvh_winner_kernel.py:96)", wl_launches, 0.0,
              wl["ms"], wl["plain_ms"], wl["bound"], wl["res"]),
        entry("shade shade_kernel", "shade_kernel.cu",
              "none (XLA ops: raytracingthenextweekcuda_tpu/models/integrator.py:360)",
              shade_launches, 0.0, shade["ms"], shade["plain_ms"], shade["bound"],
              shade["res"]),
        # Phase 25's primary wavefront; the plain versions ran on a sample
        # of blocks only, so no plain time.
        entry("K4 bvh_winner_kernel on materialball_x48",
              "bvh_winner_kernel.cu", f"{ref}bvh_winner_kernel.py:201",
              ball["launches"], 0.0, ball["k4_ms"], None, ball["k4_bound"],
              ball["res"]),
        entry("work-list worklist_kernel on materialball_x48",
              "worklist_kernel.cu", f"none (XLA ops: {ref}bvh_winner_kernel.py:96)",
              ball["launches"], 0.0, ball["wl_ms"], None, ball["wl_bound"],
              ball["wl_res"]),
        {**entry("frustum pass _build_worklist_frustum on materialball_x48",
                 "", f"none (XLA ops: {ref}bvh_winner_kernel.py:502)",
                 0, 0.0, ball["frustum_ms"], None,
                 ball["frustum_bound"], (None, None)),
         "route": "torch",
         "source": "raytracingthenextweekcuda_tpu_torch/ops/cuda/bvh_winner_kernel.py"},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
