"""The device trace of a traced run: torch.profiler over whole jobs of the
window, reduced to device busy time, kernel sums, launch counts and the
host's activity in the device's idle gaps.

Every job runs inside a `bench.job` annotation; the traced window is from
the first job's start to the last job's end, on the profiler's clock.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

# Host activities that label the device's idle gaps.
_HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    jobs: int
    window_ns: tuple          # (start, end)
    device: list              # (name, start_ns, dur_ns, activity)
    host: list                # (name, start_ns, dur_ns) of CPU ops and annotations

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def kernels(self, contains: str = "") -> list:
        return [e for e in self.device if "kernel" in e[3] and contains in e[0]]

    def busy_intervals(self) -> list:
        w0, w1 = self.window_ns
        spans = sorted((max(s, w0), min(s + d, w1)) for _, s, d, _ in self.device
                       if s + d > w0 and s < w1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        tot = collections.Counter()
        for name, _, d, _ in self.device:
            tot[name] += d * 1e-9
        return [[n, s] for n, s in tot.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds of the device by what the host was doing: the
        innermost host operation or annotation around each gap's middle."""
        w0, w1 = self.window_ns
        edges = [w0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(w1)
        gaps = sorted((g0 + g1) // 2 for g0, g1 in zip(edges[0::2], edges[1::2])
                      if g1 > g0)
        widths = {(g0 + g1) // 2: (g1 - g0) * 1e-9
                  for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0}
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        tot = collections.Counter()
        stack, j = [], 0
        for mid in gaps:
            while j < len(host) and host[j][1] <= mid:
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] + stack[-1][2] <= mid:
                stack.pop()
            tot[stack[-1][0] if stack else "(no host operation)"] += widths[mid]
        return [[n, s] for n, s in tot.most_common(top)]


def _call(e, name, default=None):
    f = getattr(e, name, None)
    return f() if f is not None else default


def _activity(e, on_device: bool) -> str:
    """The event's activity kind; older kineto events have no
    `activity_type`, and are told apart by their device and name."""
    act = _call(e, "activity_type")
    if act is not None:
        return str(act)
    name = e.name()
    if on_device:
        if _call(e, "is_user_annotation", False) or name == "bench.job":
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy")
                else "gpu_memset" if name.startswith("Memset") else "kernel")
    if _call(e, "is_user_annotation", False) or name == "bench.job":
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def _events(prof):
    out_dev, out_host, jobs = [], [], []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        act = _activity(e, on_device)
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        if on_device:
            if "annotation" not in act:
                out_dev.append((e.name(), start, dur, act))
        elif act in _HOST_ACTIVITIES:
            out_host.append((e.name(), start, dur))
            if e.name() == "bench.job":
                jobs.append((start, start + dur))
    return out_dev, out_host, jobs


def capture(job, count: int, after=None) -> Trace:
    """Run `job()` `count` times under the profiler, each in a `bench.job`
    annotation and followed by `after()` outside it, and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(count):
            with record_function("bench.job"):
                job()
            if after is not None:
                after()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    dev, host, jobs = _events(prof)
    window = (min(s for s, _ in jobs), max(e for _, e in jobs)) if jobs else (0, 0)
    return Trace(len(jobs), window, dev, host)
