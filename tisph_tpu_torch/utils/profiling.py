"""Profiling helpers: the counterpart of ``tisph_tpu.utils.profiling``.

- :class:`StepTimer`: wall-clock phase timers that wait for the device
  (``torch.cuda.synchronize`` for a result on a CUDA device, nothing on
  the CPU) so the numbers mean what they say;
- :func:`trace`: a ``torch.profiler`` run over the CPU and, when there
  is one, the CUDA device, written as a Chrome trace;
- :func:`throughput`: particle-steps/s bookkeeping, the end-to-end metric.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _devices(result) -> set[torch.device]:
    """The CUDA devices of the tensors in ``result`` (a tensor, a
    dataclass such as SimState, or a list or tuple of those)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, (list, tuple)):
        return set().union(*(_devices(r) for r in result)) if result else set()
    fields = getattr(result, "__dataclass_fields__", None)
    if fields is None:
        return set()
    return set().union(*(_devices(getattr(result, f)) for f in fields)) if fields else set()


class StepTimer:
    """Accumulating named phase timer.

    >>> t = StepTimer()
    >>> with t("step", result=state):
    ...     state = solver.step(state)   # a sync happens on context exit
    >>> t.summary()

    ``result``: a tensor, a SimState or a list of them; on exit the timer
    waits for every CUDA device they lie on (the state passed in lies
    where the step runs) and for nothing on the CPU."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        for dev in _devices(result):
            torch.cuda.synchronize(dev)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:24s} {v['mean_ms']:9.2f} ms/call x{v['count']}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    when a CUDA device is available), written to
    ``log_dir/trace.json`` as a Chrome trace (chrome://tracing, Perfetto).
    Yields the profiler, whose ``key_averages()`` gives the table."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def throughput(num_particles: int, num_steps: int, wall_seconds: float) -> dict[str, float]:
    """Particle-steps/s, steps/s and the wall time."""
    pps = num_particles * num_steps / wall_seconds
    return {
        "particle_steps_per_sec": pps,
        "steps_per_sec": num_steps / wall_seconds,
        "wall_seconds": wall_seconds,
    }
