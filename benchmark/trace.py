"""Reads a ``torch.profiler`` trace of the traced pass: the device's busy
seconds (the union of its operations' intervals), the traced window's
seconds on the same timeline, its operations by name, and its idle gaps
labelled by the benchmark's own host spans (``record_function`` ranges
named ``SPAN_PREFIX + <name>`` around ``advance``, ``state_to_host``, the
health read and an episode's start).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    # from the first host span or device operation to the last one's end:
    # the traced window, which holds every busy interval
    window_s: float
    ops: int
    by_name: dict[str, float]  # seconds by operation name
    idle_by_span: dict[str, float]  # idle seconds by the host span they fell in


def read_events(device_ops: list[tuple[float, float, str]],
                spans: list[tuple[float, float, str]]) -> DeviceTrace:
    """``device_ops`` and host ``spans`` as (start_us, end_us, name)."""
    if not device_ops:
        raise RuntimeError("the profiler recorded no device operation")
    by_name: dict[str, float] = collections.defaultdict(float)
    for s, e, name in device_ops:
        by_name[name] += (e - s) * 1e-6
    merged: list[list[float]] = []
    for s, e, _ in sorted(device_ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = collections.defaultdict(float)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        k = bisect.bisect_right(starts, mid) - 1
        label = spans[k][2] if k >= 0 and spans[k][1] >= mid else "between spans"
        idle[label] += (start - end) * 1e-6
    window = (max(e for _, e, _ in device_ops + spans)
              - min(s for s, _, _ in device_ops + spans)) * 1e-6
    return DeviceTrace(busy, window, len(device_ops), dict(by_name), dict(idle))


def profiled(fn) -> DeviceTrace:
    """Runs ``fn`` under ``torch.profiler`` (CPU and CUDA activity) and
    reads its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, spans = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.name.startswith(SPAN_PREFIX):
            # a span also shows on the device's timeline (a user annotation)
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append(rng + (e.name[len(SPAN_PREFIX):],))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(rng + (short_name(e.name),))
    return read_events(ops, spans)


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list (a name
    such as ``Memcpy DtoH (Device -> Pageable)`` is kept whole)."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")") and "::" in name:
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                return name[:k] if k else name
    return name


def top(d: dict[str, float], k: int = 10) -> list[list]:
    """The ``k`` largest entries as [[name, seconds], ...]."""
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
