"""Render timing (counterpart of raytracingthenextweekcuda_tpu/utils/timing.py).

Replaces GPUTimer's cudaEvent pairs (GPUTimer.h:12-35) and the host Clock
(CUDAPathTracer.h:65-70). PyTorch queues CUDA work and returns, so `sync`
waits for the device before a host clock is read.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager

import torch


def _tensors(result):
    if torch.is_tensor(result):
        yield result
    elif dataclasses.is_dataclass(result):
        for f in dataclasses.fields(result):
            yield from _tensors(getattr(result, f.name))
    elif isinstance(result, (tuple, list)):
        for v in result:
            yield from _tensors(v)


def sync(result) -> None:
    """Wait until the work that produces `result` (a tensor, a Film, or a
    tuple or list of them) has finished: torch.cuda.synchronize on the
    device of each CUDA tensor in it. CPU tensors are ready."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer with a device sync on stop (GPUTimer analogue)."""

    def __init__(self) -> None:
        self._start = 0.0
        self.elapsed_ms = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self, result=None) -> float:
        if result is not None:
            sync(result)
        self.elapsed_ms = (time.perf_counter() - self._start) * 1e3
        return self.elapsed_ms


@contextmanager
def timed(label: str, printer=print):
    """Context manager printing '<label>: N ms' around its body, as the
    reference renderer's GPUTimer around the offline render
    (main.cu:944-946). It yields a dict: put the body's result under
    "result" and the device is synchronized on it before the clock stops."""
    t = Timer().start()
    box = {}
    try:
        yield box
    finally:
        ms = t.stop(box.get("result"))
        printer(f"{label}: {ms:.3f} ms")


def throughput(paths: int, ms: float) -> float:
    """Paths (camera rays) per second from a timing."""
    return paths / (ms / 1e3) if ms > 0 else float("inf")
