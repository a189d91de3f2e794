"""The job kinds of the benchmark: closed loops that drive the program's
entries for a measured window, and keep what the judge compares.

A traffic file (`traffic/<mix>.json`) names its kind and the kind's
parameters; `KINDS` maps the kind to its driver. A driver warms up the
shapes of its traffic (set-up), runs jobs one after another until the
window closes, each ended by a synchronize, and keeps the judged pixels of
the jobs the judge will see. Its job sizes and scripts come from `--seed`
alone.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

def judged_pixels(rng: np.random.Generator, width: int, height: int,
                  count: int) -> np.ndarray:
    """A seeded sample of pixel ids (y * width + x, y = 0 at the bottom
    of the film), sorted."""
    count = min(count, width * height)
    return np.sort(rng.choice(width * height, size=count, replace=False))


class Judged:
    """The outputs kept for the judge: the last job's, and a uniform
    sample of `count - 1` of the earlier jobs' (reservoir sampling, drawn
    from the seed), so what is kept does not grow with the window."""

    def __init__(self, count: int, rng: np.random.Generator):
        self.size, self.rng = max(count - 1, 0), rng
        self.sample: list[tuple] = []
        self.last: tuple | None = None
        self.seen = 0

    def add(self, job: int, output) -> None:
        if self.last is not None:
            if len(self.sample) < self.size:
                self.sample.append(self.last)
            elif self.size:
                k = int(self.rng.integers(self.seen + 1))
                if k < self.size:
                    self.sample[k] = self.last
            self.seen += 1
        self.last = (job, output)

    def jobs(self) -> list[tuple]:
        kept = self.sample + ([self.last] if self.last is not None else [])
        return sorted(kept, key=lambda j: j[0])


class Offline:
    """Image jobs through `models.integrator.render`: one film a job, with
    its own `cfg.seed` drawn from the run's seed."""

    def __init__(self, scene, camera, traffic: dict, seed: int, device):
        from raytracingthenextweekcuda_tpu_torch.config import RenderConfig

        self.scene, self.camera, self.t, self.device = scene, camera, traffic, device
        self.rng = np.random.default_rng([seed, 1])
        self.base = RenderConfig(width=traffic["width"], height=traffic["height"],
                                 spp=traffic["spp"], bounces=traffic["bounces"],
                                 spp_per_pass=traffic.get("spp_per_pass", 0),
                                 russian_roulette=traffic.get("russian_roulette", False),
                                 rr_start_bounce=traffic.get("rr_start_bounce", 3))
        self.pixels = judged_pixels(self.rng, self.base.width, self.base.height,
                                    traffic["judge_pixels"])
        self._pix = torch.from_numpy(self.pixels).to(device)
        self.seeds: list[int] = []
        # (accum at the judged pixels, samples) of the jobs to judge
        self.kept = Judged(traffic["judge_jobs"], np.random.default_rng([seed, 3]))
        self.times: list[float] = []

    def _render(self, seed: int):
        from raytracingthenextweekcuda_tpu_torch.models import integrator

        cfg = dataclasses.replace(self.base, seed=seed)
        film = integrator.render(self.scene, self.camera, cfg, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return film

    def warmup(self) -> None:
        film = self._render(int(self.rng.integers(0, 2**31)))
        film.accum.reshape(-1, 3).index_select(0, self._pix)

    def job(self) -> None:
        seed = int(self.rng.integers(0, 2**31))
        t0 = time.perf_counter()
        film = self._render(seed)
        self.times.append(time.perf_counter() - t0)
        self.seeds.append(seed)
        self._last = film

    def keep(self) -> None:
        """Keep the last job's film at the judged pixels (outside the job)."""
        film, self._last = self._last, None
        accum = film.accum.reshape(-1, 3).index_select(0, self._pix)
        self.kept.add(self.jobs - 1, (accum, int(film.sample_count)))

    @property
    def jobs(self) -> int:
        return len(self.times)

    def end_to_end(self, window_s: float) -> dict:
        paths = self.jobs * self.base.num_pixels * self.base.spp
        return {"paths_per_s": paths / window_s}

    def records(self) -> list[dict]:
        return [{"job": i, "seed": self.seeds[i], "accum": accum.cpu(),
                 "samples": samples} for i, (accum, samples) in self.kept.jobs()]

    def release(self) -> None:
        self.kept = None
        self.scene = None


def preview_script(seed: int, traffic: dict, frame: int) -> list[tuple]:
    """The camera commands applied before `frame` of the preview script:
    [(command, delta)]. Each cycle is a motion burst of `burst_frames`
    frames with one command every `frames_per_command` frames, then
    `rest_frames` frames that accumulate. A burst's first half presses
    keys of the live viewer, drawn from the seed and the cycle's number;
    the traffic file's `keys` gives each key's command and fixed step. Its
    second half undoes the first in reverse order, each command with the
    opposite step, so every cycle starts from the same pose."""
    cycle = traffic["burst_frames"] + traffic["rest_frames"]
    c, k = divmod(frame, cycle)
    every = traffic["frames_per_command"]
    if k >= traffic["burst_frames"] or k % every:
        return []
    n_cmd = traffic["burst_frames"] // every
    keys = sorted(traffic["keys"])
    rng = np.random.default_rng([seed, 2, c])
    drawn = [tuple(traffic["keys"][keys[int(rng.integers(len(keys)))]])
             for _ in range(n_cmd // 2)]
    plan = drawn + [(name, -delta) for name, delta in reversed(drawn)]
    plan += [drawn[-1]] * (n_cmd - len(plan))
    name, delta = plan[k // every]
    return [(name, float(delta))]


class Preview:
    """Live-preview frames through `apps.interactive.InteractiveSession`:
    `step()` and then `image()` a frame, camera commands from
    `preview_script` between frames."""

    def __init__(self, scene, camera, traffic: dict, seed: int, device):
        from raytracingthenextweekcuda_tpu_torch.config import RenderConfig

        self.scene, self.camera, self.t, self.device = scene, camera, traffic, device
        self.rng = np.random.default_rng([seed, 1])
        self.session_seed = int(self.rng.integers(0, 2**31))
        self.script_seed = int(self.rng.integers(0, 2**31))
        self.cfg = RenderConfig(width=traffic["width"], height=traffic["height"],
                                spp=traffic["spp_per_frame"], bounces=traffic["bounces"],
                                seed=self.session_seed)
        self.pixels = judged_pixels(self.rng, self.cfg.width, self.cfg.height,
                                    traffic["judge_pixels"])
        y = self.pixels // self.cfg.width
        self._rows = self.cfg.height - 1 - y   # the image's row 0 is the top
        self._cols = self.pixels % self.cfg.width
        self.session = None
        # u8 values at the judged pixels of the frames to judge
        self.kept = Judged(traffic["judge_jobs"], np.random.default_rng([seed, 3]))
        self.times: list[float] = []

    def _session(self, seed: int):
        from raytracingthenextweekcuda_tpu_torch.apps.interactive import (
            InteractiveSession,
        )

        return InteractiveSession(self.scene, self.camera,
                                  dataclasses.replace(self.cfg, seed=seed),
                                  spp_per_frame=self.t["spp_per_frame"],
                                  device=self.device)

    @staticmethod
    def _apply(session, commands) -> None:
        for name, delta in commands:
            if name == "orbit":
                session.orbit(radians=delta)
            else:
                getattr(session, name)(delta)

    def warmup(self) -> None:
        s = self._session(int(self.rng.integers(0, 2**31)))
        for cmd in ([("yaw", 0.5)], [], [], [("yaw", -0.5)], []):
            self._apply(s, cmd)
            s.step()
            s.image()
        self.session = self._session(self.session_seed)

    def job(self) -> None:
        frame = len(self.times)
        t0 = time.perf_counter()
        self._apply(self.session, preview_script(self.script_seed, self.t, frame))
        self.session.step()
        self._last = self.session.image()
        self.times.append(time.perf_counter() - t0)

    def keep(self) -> None:
        """Keep the last frame's image; records() reads its judged pixels."""
        img, self._last = self._last, None
        self.kept.add(self.jobs - 1, img)

    @property
    def jobs(self) -> int:
        return len(self.times)

    def end_to_end(self, window_s: float) -> dict:
        ms = np.asarray(self.times) * 1e3
        return {"frame_ms_p95": float(np.percentile(ms, 95))}

    def records(self) -> list[dict]:
        return [{"job": i, "frame": i, "u8": img[self._rows, self._cols]}
                for i, img in self.kept.jobs()]

    def release(self) -> None:
        self.session = None
        self.scene = None


KINDS = {"offline": Offline, "preview": Preview}
