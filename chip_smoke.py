"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile the render kernel K1 (csrc/render_kernel.cu) with nvcc;
  3. kernel vs plain: K1 against its plain torch version on the same CUDA
     tensors, 5 presets at 64x64, 4 spp, 6 bounces, plus Cornell with
     Russian roulette and with the sky off (rtol = atol = 1e-4; smallpt by
     the statistical rule of tests/test_torch_bounce_kernel.py), and a
     small Cornell render on the card against the same render on the CPU;
  4. main path: the headline benchmark (Cornell 512x512, 128 spp, 10
     bounces, one pass) through integrator.render, counting K1's launches
     and checking the image;
  5. plain time: the plain version at the headline config (at 32 spp,
     scaled, when 128 would exceed a minute), and K1 against it on those
     same inputs (rtol = atol = 1e-4).

Then one JSON line with the kernel's numbers, the nvidia-smi line, and a
last JSON line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before printing results.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")

    from raytracingthenextweekcuda_tpu_torch.apps.bench import card_info, run_bench
    from raytracingthenextweekcuda_tpu_torch.config import RenderConfig
    from raytracingthenextweekcuda_tpu_torch.models import camera as cam
    from raytracingthenextweekcuda_tpu_torch.models import integrator, presets
    from raytracingthenextweekcuda_tpu_torch.models.film import to_image
    from raytracingthenextweekcuda_tpu_torch.models.scene import finalize
    from raytracingthenextweekcuda_tpu_torch.ops import threefry
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import bounce_kernel as bk
    from raytracingthenextweekcuda_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_info()

    # 1. device
    print(f"[1 device] {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load()
    ptxas = [ln.split(":", 1)[-1].strip() for ln in build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] K1 built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_SECONDS:.2f} s) -> {build.library_path().name} | "
          f"ptxas: {'; '.join(ptxas[:2])}", flush=True)

    # 3. kernel vs plain on the card
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
    max_err = 0.0
    for case, preset, extra in cases:
        scene, camera = preset()
        scene = finalize(scene, use_bvh=False)
        cfg = RenderConfig(width=64, height=64, spp=4, bounces=6,
                           spp_per_pass=4, **extra)
        frame = cam.derive(camera, cfg.aspect_ratio)
        words = threefry.split(threefry.key(7), 4)
        inp = bk.render_inputs(scene.packed, frame, words, cfg, device=dev)
        k1 = bk.render_kernel(inp)
        plain = bk.render_reference(inp)
        torch.cuda.synchronize()
        k1, plain = k1.cpu().numpy(), plain.cpu().numpy()
        if k1.shape != (cfg.num_pixels, 3) or not np.isfinite(k1).all():
            raise AssertionError(f"{case}: K1 output not finite or misshapen")
        diff = np.abs(k1 - plain)
        if case == "smallpt":
            frac = float((diff > 0.2).mean())
            if frac >= 0.05:
                raise AssertionError(f"smallpt: {frac:.2%} of values off by > 0.2")
            np.testing.assert_allclose(k1.mean(), plain.mean(), rtol=1e-2)
            note = f"frac>0.2 {frac:.4%}"
        else:
            np.testing.assert_allclose(k1, plain, rtol=1e-4, atol=1e-4,
                                       err_msg=case)
            note = "rtol=atol=1e-4"
        max_err = max(max_err, float(diff.max()))
        print(f"[3 kernel-vs-plain] {case}: max|diff| {float(diff.max()):.3e} "
              f"({note}) mean {float(k1.mean()):.6f}", flush=True)

    scene, camera = presets.cornell_box()
    scene = finalize(scene)
    small = RenderConfig(width=32, height=32, spp=4, bounces=6, spp_per_pass=2)
    on_card = integrator.render(scene, camera, small, device=dev).accum.cpu().numpy()
    on_cpu = integrator.render(scene, camera, small, device="cpu").accum.numpy()
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)
    max_err = max(max_err, float(np.abs(on_card - on_cpu).max()))
    print(f"[3 card-vs-cpu] cornell 32x32 render: max|diff| "
          f"{float(np.abs(on_card - on_cpu).max()):.3e}", flush=True)

    # 4. main path
    bk.KERNEL_LAUNCHES = 0
    result = run_bench(device=dev, keep_film=True)
    launches = bk.KERNEL_LAUNCHES
    film = result.pop("film")
    if launches <= 0:
        raise AssertionError("the headline render did not launch K1")
    mean = film.mean.cpu().numpy()
    if mean.shape != (512, 512, 3) or not np.isfinite(mean).all():
        raise AssertionError("headline image not finite or misshapen")
    img = to_image(film).astype(np.float64)  # row 0 at the top
    left = img[170:340, 5:40].reshape(-1, 3).mean(0)
    right = img[170:340, -40:-5].reshape(-1, 3).mean(0)
    if not (left[0] > left[2] and right[2] > right[0]):
        raise AssertionError(f"wall colours wrong: left {left}, right {right}")
    print(f"[4 main path] {json.dumps(result)} | K1 launches {launches} | "
          f"left wall rgb {left.round(1).tolist()} right wall rgb "
          f"{right.round(1).tolist()}", flush=True)

    # 5. plain time at the headline config; K1's device time beside it
    cfg = RenderConfig(width=512, height=512, spp=128, bounces=10, spp_per_pass=128)
    frame = cam.derive(camera, cfg.aspect_ratio)
    words = threefry.split(threefry.fold_in(threefry.key(cfg.seed), 0), 128)
    inp = bk.render_inputs(scene.packed, frame, words, cfg, device=dev)
    k1_ms = _event_ms(lambda: bk.render_kernel(inp), reps=3)
    one = bk.render_inputs(scene.packed, frame, words[:1], cfg, device=dev)
    t0 = time.perf_counter()
    bk.render_reference(one)
    torch.cuda.synchronize()
    est_ms = (time.perf_counter() - t0) * 1000.0 * 128
    plain_spp = 128 if est_ms <= 60_000 else 32
    sub = bk.render_inputs(scene.packed, frame, words[:plain_spp], cfg, device=dev)
    t0 = time.perf_counter()
    plain = bk.render_reference(sub)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0 * (128 / plain_spp)
    # K1 against the plain version on the same headline inputs.
    k1 = bk.render_kernel(sub).cpu().numpy()
    plain = plain.cpu().numpy()
    if k1.shape != (cfg.num_pixels, 3) or not np.isfinite(k1).all():
        raise AssertionError("headline: K1 output not finite or misshapen")
    np.testing.assert_allclose(k1, plain, rtol=1e-4, atol=1e-4,
                               err_msg="headline")
    head_err = float(np.abs(k1 - plain).max())
    max_err = max(max_err, head_err)
    print(f"[5 plain time] headline config: K1 {k1_ms:.3f} ms (CUDA events, "
          f"mean of 3) | plain {plain_ms:.1f} ms (host clock, {plain_spp} spp"
          f"{' x4 scaled' if plain_spp != 128 else ''}) | K1 vs plain at "
          f"{plain_spp} spp: max|diff| {head_err:.3e} (rtol=atol=1e-4) | {card}",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "K1 render_kernel",
        "route": "cuda",
        "source": "raytracingthenextweekcuda_tpu_torch/csrc/render_kernel.cu",
        "replaces": "raytracingthenextweekcuda_tpu/ops/pallas/bounce_kernel.py:1466",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
