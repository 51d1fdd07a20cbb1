"""Profiling helpers: the counterpart of ``tisph_tpu.utils.profiling``,
and the port's own tracer.

- :class:`StepTimer`: wall-clock phase timers that wait for the device
  (``torch.cuda.synchronize`` for a result on a CUDA device, nothing on
  the CPU) so the numbers mean what they say;
- :func:`trace`: a ``torch.profiler`` run over the CPU and, when there
  is one, the CUDA device, written as a Chrome trace with the program's
  spans on a host track of their own;
- :func:`throughput`: particle-steps/s bookkeeping, the end-to-end metric;
- the tracer: :func:`span` at the program's layer boundaries (the solver's
  call, the graph runner's key, copies, replays and captures, the dump,
  the health read), recorded in memory while :func:`recording` is on or
  a ``torch.profiler`` session records, and read back by
  :func:`recorded`; :func:`count` and :func:`counters`, a process-wide
  registry of counters at build, capture and call granularity, and of the
  kernel wrappers' launch counters (:func:`launch_counters`).

A span is stamped with ``time.time_ns()``, the Unix-epoch clock on which
``torch.profiler`` stamps its events (``start_ns``; a Chrome trace's
``ts`` is ``(start_ns - baseTimeNanoseconds) / 1e3``), so a span lies
directly against the device's kernels.  The tracer opens no profiler
range (no user annotation): a range costs microseconds with no profiler
running, and under one a range that holds kernels shows on the device's
timeline as an annotation, which a reader of that timeline would count
as device work.  With recording off a span site costs one flag test and
returns a shared no-op context: it keeps nothing and calls no torch API.
Spans nest by the order they open, on the host thread that runs the
solver (the tracer keeps one stack).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler


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
    ``log_dir/trace.json`` as a Chrome trace (chrome://tracing, Perfetto)
    with the program's spans of the block on a host track of their own.
    Yields the profiler, whose ``key_averages()`` gives the table."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, recorded())


def throughput(num_particles: int, num_steps: int, wall_seconds: float) -> dict[str, float]:
    """Particle-steps/s, steps/s and the wall time."""
    pps = num_particles * num_steps / wall_seconds
    return {
        "particle_steps_per_sec": pps,
        "steps_per_sec": num_steps / wall_seconds,
        "wall_seconds": wall_seconds,
    }


# -- the tracer ---------------------------------------------------------


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span: its name, its start and end on the profiler's
    clock (Unix-epoch ns), the index of the enclosing span in the record
    (-1 for a root), the call id of its root span, and its attributes."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    attrs: dict


_OFF = contextlib.nullcontext()  # what a span site gets with recording off
_switched_on = 0  # depth of open ``recording()`` blocks
_live = False  # a session is open: the next span appends to its record
_record: list[Span] = []
_open: list[int] = []  # indices of the spans open now, innermost last
_calls = 0  # root spans of the session so far
_counters: dict[str, float] = {}


def is_recording() -> bool:
    """Whether a span opened now is recorded: inside ``recording()``, or
    while a ``torch.profiler`` session records."""
    return bool(_switched_on or _autograd_profiler._is_profiler_enabled)


def span(name: str, **attrs):
    """A context manager around one layer's work.  While recording, it
    appends a :class:`Span` to the session's record and yields it (its
    ``attrs`` may gain entries before the block ends); otherwise it
    yields None and records nothing.  A session starts at the first span
    recorded after recording was off, and replaces the previous record."""
    global _live
    if _switched_on or _autograd_profiler._is_profiler_enabled:
        return _Recorder(name, attrs)
    _live = False
    return _OFF


def _new_session() -> None:
    global _live, _calls
    _record.clear()
    _open.clear()
    _calls = 0
    _live = True


class _Recorder:
    __slots__ = ("span",)

    def __init__(self, name: str, attrs: dict):
        self.span = Span(name, 0, 0, -1, 0, attrs)

    def __enter__(self) -> Span:
        global _calls
        if not _live:
            _new_session()
        sp = self.span
        if _open:
            sp.parent = _open[-1]
            sp.call = _record[sp.parent].call
        else:
            _calls += 1
            sp.call = _calls
        _open.append(len(_record))
        _record.append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        if _open:
            _open.pop()


@contextlib.contextmanager
def recording():
    """Record the spans opened inside the block, as a new session (one
    nested in another continues the outer one's)."""
    global _switched_on, _live
    if not _switched_on:
        _new_session()
    _switched_on += 1
    try:
        yield
    finally:
        _switched_on -= 1
        if not _switched_on:
            _live = False


def recorded() -> list[Span]:
    """The spans of the last session, in the order they opened."""
    return list(_record)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the process-wide counter ``name`` (always on: keep
    it to launch, build, capture and call granularity, never per replay)."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, float]:
    """The process-wide counters: ``graphs.captures`` and
    ``graphs.capture_s`` (the graph runner's warm-ups and captures),
    ``build.s`` (seconds the kernel build compiled, 0 when it found the
    library), ``bind.calls``, ``bind.s`` and ``bind.boundary_rows``
    (``SolverBase.bind``), and the launch counters: ``launches.<wrapper>``
    for every kernel launch, and on the sweep wrappers
    ``part_launches.<wrapper>`` (the launches over part of the arrays) and
    ``rows.<wrapper>`` (the rows the launches swept).  Each launch counts
    in Python (``ops.cuda.build.launch``); a graph replay makes no Python
    call, so the graph runner takes back what a warm-up and a capture
    counted and adds replays times captured counts once a rollout."""
    return dict(_counters)


_LAUNCH_KINDS = ("launches.", "part_launches.", "rows.")  # the launch counters' prefixes


def launch_counters() -> dict[str, float]:
    """The launch counters (see :func:`counters`), by name."""
    return {k: v for k, v in _counters.items() if k.startswith(_LAUNCH_KINDS)}


def set_launch_counters(values: dict[str, float]) -> None:
    """Set every launch counter to its value in ``values``, 0 where it has
    none; the other counters stay as they are."""
    for k in launch_counters():
        _counters[k] = values.get(k, 0)


def launches() -> int:
    """Every launch counted (the part launches are among them)."""
    return sum(v for k, v in _counters.items() if k.startswith("launches."))


def sweep_rows() -> int:
    """The rows the sweep wrappers' launches covered, summed."""
    return sum(v for k, v in _counters.items() if k.startswith("rows."))


# the host track the program's spans take in a Chrome trace
_SPAN_TID = 2 ** 31 - 7


def _add_spans(path: str, spans: list[Span]) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete
    events on their own host track, on the file's time base."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": _SPAN_TID,
                   "args": {"name": "tisph_tpu_torch spans"}})
    for sp in spans:
        events.append({"ph": "X", "cat": "tisph", "name": sp.name, "pid": pid,
                       "tid": _SPAN_TID, "ts": (sp.start_ns - base) / 1e3,
                       "dur": (sp.end_ns - sp.start_ns) / 1e3,
                       "args": {"parent": sp.parent, "call": sp.call, **sp.attrs}})
    with open(path, "w") as f:
        json.dump(doc, f)
