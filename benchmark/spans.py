"""The program's spans on a traced run's device trace, for the per-layer
readers: images counted by their `integrator.render` spans, the device's
idle time while the host is inside named spans, and the device time of
the operations enqueued inside named spans.

The program marks its layers with `torch.profiler.record_function` spans
(its `utils/timing.span`); they reach `Trace.host` as user annotations, on
the clock of the device's events. `Trace` keeps no correlation id, so a
device operation is paired with the host call that enqueued it by order:
on one stream the i-th kernel, copy or fill on the device was enqueued by
the i-th enqueue call on the host. An operation belongs to the innermost
program span around its enqueue call's start, and to that span's parents.
A trace whose two counts differ, that holds a graph launch, or in which a
paired operation starts on the device before its enqueue call started on
the host (the two clocks disagree) gets no pairing: None, and the reason
on standard error.
"""

from __future__ import annotations

import sys

# The spans of the program, by name (raytracingthenextweekcuda_tpu_torch).
RENDER = "integrator.render"
PROGRAM_SPANS = frozenset({
    RENDER, "integrator.prep", "k1.prep", "wavefront.prep", "wavefront.sort",
    "host.read", "wavefront.bounce", "k3.intersect", "k4.worklist", "k4.winner",
    "wavefront.unsort",
})
# Host calls that enqueue one device operation. On the H100 only the first,
# the copy and the fill were seen (K1, K3 and K4's ctypes launches included);
# any other enqueue call leaves the counts apart, and then nothing is paired.
ENQUEUE_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
})
GRAPH_CALLS = frozenset({"cudaGraphLaunch", "cuGraphLaunch"})
# How far a paired device operation may seem to start before its enqueue
# call: beyond it the device's clock is taken to disagree with the host's.
CLOCK_SLACK_NS = 100_000
_DEVICE_KINDS = ("kernel", "memcpy", "memset")

_last: tuple = (None, None)


def _note(msg: str) -> None:
    print(f"[spans] {msg}", file=sys.stderr, flush=True)


def _in_window(trace, names) -> list:
    """(start, end) of the host events named in `names` that lie wholly
    inside the traced window, by start."""
    w0, w1 = trace.window_ns
    return sorted((s, s + d) for n, s, d in trace.host
                  if n in names and s >= w0 and s + d <= w1)


def _clipped(trace, names) -> list:
    """(start, end) of the host events named in `names`, cut to the traced
    window; those outside it left out."""
    w0, w1 = trace.window_ns
    return sorted((max(s, w0), min(s + d, w1)) for n, s, d in trace.host
                  if n in names and s < w1 and s + d > w0)


def images(trace) -> int:
    """The `integrator.render` spans wholly inside the traced window."""
    return len(_in_window(trace, {RENDER}))


def count(trace, name: str) -> int:
    """The spans named `name` wholly inside the traced window."""
    return len(_in_window(trace, {name}))


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_intervals(trace) -> list:
    """The traced window less `Trace.busy_intervals()`: [start, end) pairs."""
    w0, w1 = trace.window_ns
    edges = [w0]
    for s, e in trace.busy_intervals():
        edges += [s, e]
    edges.append(w1)
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_ns(trace, names) -> int | None:
    """Device idle time inside the traced window, in ns, while the host is
    inside a span named in `names` (children included); None when no such
    span reaches into the window."""
    spans = _union(_clipped(trace, set(names)))
    if not spans:
        return None
    total, j = 0, 0
    for a, b in idle_intervals(trace):
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += max(0, min(b, spans[k][1]) - max(a, spans[k][0]))
            k += 1
    return total


def _chains(trace, starts: list) -> list:
    """For each host time in `starts` (ascending), the names of the program
    spans around it, innermost first."""
    spans = sorted(((s, d, n) for n, s, d in trace.host if n in PROGRAM_SPANS),
                   key=lambda x: (x[0], -x[1]))
    stack, j, out = [], 0, []
    for t in starts:
        while j < len(spans) and spans[j][0] <= t:
            stack.append(spans[j])
            j += 1
        stack = [sp for sp in stack if sp[0] + sp[1] > t]
        out.append(tuple(sp[2] for sp in reversed(stack)))
    return out


def attribution(trace) -> list | None:
    """[(enqueue call's start, device ns, span names around that start,
    innermost first)] for every kernel, copy and fill of the trace, or
    None when the device operations cannot be paired with their enqueue
    calls."""
    global _last
    if _last[0] is trace:
        return _last[1]
    result = None
    if any(n in GRAPH_CALLS for n, _, _ in trace.host):
        _note("a graph launch in the trace: its kernels have no enqueue call each")
    else:
        ops = sorted((s, d) for _, s, d, act in trace.device
                     if any(k in act for k in _DEVICE_KINDS))
        calls = sorted((s, d) for n, s, d in trace.host if n in ENQUEUE_CALLS)
        lead = max((t - s for (t, _), (s, _) in zip(calls, ops)), default=0)
        if len(ops) != len(calls):
            _note(f"{len(ops)} device operations against {len(calls)} enqueue "
                  "calls: no pairing")
        elif lead > CLOCK_SLACK_NS:
            _note(f"a device operation starts {lead * 1e-3:.1f} us before its "
                  "enqueue call: the clocks disagree, no pairing")
        else:
            _note(f"paired {len(ops)} device operations with {len(calls)} "
                  "enqueue calls")
            chains = _chains(trace, [s for s, _ in calls])
            result = [(t, d, c) for (t, _), (_, d), c in zip(calls, ops, chains)]
    _last = (trace, result)
    return result


def device_ns(trace, inside, outside=()) -> int | None:
    """Device time, in ns, of the operations enqueued inside the traced
    window, inside a span named in `inside` and inside none named in
    `outside`; None without a pairing or without a span named in `inside`
    that reaches into the window."""
    if not _clipped(trace, set(inside)):
        return None
    ops = attribution(trace)
    if ops is None:
        return None
    w0, w1 = trace.window_ns
    inside, outside = set(inside), set(outside)
    return sum(d for t, d, chain in ops if w0 <= t < w1
               and inside.intersection(chain) and not outside.intersection(chain))


def per_image(trace, value, scale: float = 1.0) -> float | None:
    """`value` times `scale` over the trace's images; None without a value
    or an image."""
    if value is None:
        return None
    n = images(trace)
    return value * scale / n if n else None
