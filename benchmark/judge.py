"""The comparison that decides `correct`: the program's outputs from the
window against the plain reference (reference/pathtracer.py).

Offline: for each judged image job, the film's mean radiance at the
judged pixels against the reference's mean over the same samples (the
job's own key tree). A value is off when it differs by more than
`MEAN_RTOL * (1 + |reference|)`: rounding of the sums in another order
stays far inside it, a path that takes another turn, or a wrong sample,
falls outside.

Preview: for each judged frame, the displayed u8 image at the judged
pixels against the reference's tonemap of its own film: the camera after
the script's commands, the frames since the last reset, each frame's pass
key. A value is off when it differs by more than `U8_TOL` levels.

The number compared is `mismatch_share`, the share of judged values that
are off, held to the cell's limit (`limits/<workload>.json`).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from benchmark import drivers, scenedata
from benchmark.reference import pathtracer as pt
from benchmark.reference.session import CameraScript

MEAN_RTOL = 1e-4
U8_TOL = 1
LIMITS_DIR = pathlib.Path(__file__).resolve().parent / "limits"


def load_limits(workload: str) -> dict:
    path = LIMITS_DIR / f"{workload}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits file {path}")
    return json.loads(path.read_text())


def _opts(traffic: dict) -> dict:
    return dict(width=traffic["width"], height=traffic["height"],
                bounces=traffic["bounces"], tmin=1e-3, sky=True,
                russian_roulette=traffic.get("russian_roulette", False),
                rr_start=traffic.get("rr_start_bounce", 3))


def reference_offline(cfg: dict, traffic: dict, seed: int, pixels, device,
                      ft=torch.float32, fhi=torch.float64, scene=None):
    """(the reference's film mean at `pixels` (P, 3) float32 on the CPU,
    live path-bounces) of the image job rendered with `cfg.seed` = seed."""
    rs = scene or pt.build_scene(cfg, scenedata.scene_meshes(cfg), device, ft)
    frame = pt.frame_vector(pt.camera_from(cfg["scene"]["camera"]),
                            traffic["width"] / traffic["height"])
    words = pt.render_sample_words(seed, traffic["spp"], traffic.get("spp_per_pass", 0))
    pix = torch.as_tensor(pixels, device=device)
    accum, work = pt.trace_pixels(rs, frame, pix, words, _opts(traffic), ft, fhi)
    return pt.film_mean(accum.float(), traffic["spp"]).cpu(), work


def preview_words(traffic: dict, session_seed: int, first: int, last: int):
    """Key words of the samples of frames first..last of a session."""
    k = pt.key(session_seed)
    spf = traffic["spp_per_frame"]
    return np.concatenate([pt.split(pt.fold_in(k, j), spf)
                           for j in range(first, last + 1)])


def reference_preview(cfg: dict, traffic: dict, session_seed: int,
                      script_seed: int, frame: int, pixels, device,
                      ft=torch.float32, fhi=torch.float64, scene=None):
    """The reference's u8 values at `pixels` (P, 3) of the image shown
    after `frame`, and its live path-bounces."""
    rs = scene or pt.build_scene(cfg, scenedata.scene_meshes(cfg), device, ft)
    cam = CameraScript(pt.camera_from(cfg["scene"]["camera"]))
    reset = 0
    for j in range(frame + 1):
        cmds = drivers.preview_script(script_seed, traffic, j)
        for name, delta in cmds:
            cam.apply(name, delta)
        if cmds:
            reset = j
    frame_vec = pt.frame_vector(cam.params, traffic["width"] / traffic["height"])
    words = preview_words(traffic, session_seed, reset, frame)
    pix = torch.as_tensor(pixels, device=device)
    accum, work = pt.trace_pixels(rs, frame_vec, pix, words, _opts(traffic), ft, fhi)
    n = (frame - reset + 1) * traffic["spp_per_frame"]
    return pt.tonemap_u8(pt.film_mean(accum.float(), n)).cpu(), work


def off_mask(kind: str, program, reference) -> torch.Tensor:
    """Which judged values of one job are off."""
    if kind == "offline":
        p, r = program.float(), reference.float()
        return ~((p - r).abs() <= MEAN_RTOL * (1.0 + r.abs()))
    p = torch.as_tensor(np.asarray(program)).to(torch.int32)
    return (p - reference.to(torch.int32)).abs() > U8_TOL


def judge(kind: str, cfg: dict, traffic: dict, driver, records: list,
          device, ft=torch.float32, fhi=torch.float64) -> dict:
    """Compare the judged records of a window with the reference; returns
    the numbers compared, per-job results and the reference's work."""
    rs = pt.build_scene(cfg, scenedata.scene_meshes(cfg), device, ft)
    off = total = 0
    work = []
    per_job = []
    for rec in records:
        if kind == "offline":
            ref, w = reference_offline(cfg, traffic, rec["seed"], driver.pixels,
                                       device, ft, fhi, rs)
            samples = rec["samples"]
            prog = pt.film_mean(rec["accum"].float(), samples)
        else:
            ref, w = reference_preview(cfg, traffic, driver.session_seed,
                                       driver.script_seed, rec["frame"],
                                       driver.pixels, device, ft, fhi, rs)
            prog = rec["u8"]
        mask = off_mask(kind, prog, ref)
        n_off, n = int(mask.sum()), mask.numel()
        off += n_off
        total += n
        work.append(w)
        per_job.append((rec["job"], n_off / n))
    return {"mismatch_share": off / max(total, 1), "per_job": per_job,
            "path_bounces": work, "judged_pixels": len(driver.pixels)}
