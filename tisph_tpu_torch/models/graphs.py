"""One R-group, one CUDA graph replay: the port's counterpart of
``tisph_tpu``'s one-dispatch rollout (``solver_base.py:8-12``, ``:277-326``,
a jitted ``lax.fori_loop`` over groups; ``wcsph_rigid.py:143-186`` for the
coupled step; ``solver_base.py:338-390`` for ``rollout_emit``;
``parallel/domain2d.py``'s jitted ``shard_map`` for the rectangle).

:class:`GroupRunner` owns a solver's static carry (the tensor fields of
every carry element: the ``SimState``, or a list of per-shard ones, the
``RigidState`` on the coupled path, and the emitters' seed tensors), one
``torch.cuda.CUDAGraph`` per group key and one memory pool the graphs
share.  A captured group is the eager group's body: ``_build`` and k
substeps, which end by writing the new carry back into the static buffers
inside the graph, so replays chain with no host step between them.  A
rollout copies the carry in once, replays its groups and clones the carry
out once, with no synchronisation.

Emission (``emitters=``): whether a batch fires depends only on host
counters and on the live rows (``num_active``, host ints), so before each
group the host counts the emitters' steps (``geometry.emitter.
count_step``), as the eager loop does, and gets the group's fire pattern
(per emission slot, which emitters fire; a slot is before the rebuild at
R = 1, before each substep at R > 1) and each batch's start row, a global
row on a list of shards.  The pattern is part of the key; the start rows
go into 0-d int64 buffers, one per (slot, emitter), which the host fills
on the stream before the replay.  The solver writes a batch from its start
row (``_emit_batch``: the slab's a fixed-shape scatter into every shard).
The emitters' seed tensors are graph inputs, copied in at every call as
the state is; their counters and ``num_active`` stay host ints.  A solver
that tests a batch's room on the device (``emit_on_device``, the
rectangle) gets from the host only the cadence: the pattern is which
emitters are due, and the solver's device counters say what fired.

Where a capture could go wrong, and what the runner does about it:

- first use: ``ops/consts.py``'s ``device_constant`` fills its cache with
  a host-to-device copy, ``ops/cuda/build.py``'s ``load`` may run
  ``nvcc`` and ``torch.sort`` sizes its workspace on first call.  Before
  each capture one warm-up group runs eagerly on a side stream, on
  throwaway copies of the buffers, so the state never advances twice;
  both caches also refuse a first fill inside a capture;
- state outside the carry: tensors a group updates in place (the
  rectangle's live-row counts, flags and emitted rows, the slab's halo
  flag and seam-guard count, ``SolverBase._inplace``) keep their
  addresses for the graph, and the warm-up's updates are undone;
- streams: every kernel wrapper reads ``torch.cuda.current_stream()`` at
  call time, which inside ``torch.cuda.graph`` is the capture stream;
- failure: a capture that fails raises, naming the part of the group
  that broke it (no eager fallback);
- aliasing: graph tensors live in the pool and the next replay rewrites
  the buffers, so the carry a rollout returns is a clone and no group
  cache leaves the graph;
- launch counters: every kernel launch counts in Python, in
  ``utils.profiling``'s registry (``launches.*``, ``part_launches.*`` and
  ``rows.*``, whichever kernels there are), and a replay makes no Python
  call, so the runner takes back what a warm-up and a capture counted,
  keeps the capture's rises per key, counts a rollout's replays per key
  and adds replays times rises at the rollout's end: between calls the
  counters read as if every group had run eagerly;
- bitwise: a replay runs the eager group's kernels with the same launch
  shapes in the same order (``launch_shape`` reads only the row count),
  so it equals the eager group bitwise, not within a tolerance.

``capture=False`` runs the same plumbing (copy in, the host's emission
count, group on the buffers, write back, tail group, copy out) with a
direct call of the group in place of each replay: the CPU tests drive it
so.

Spans (``utils.profiling``, recorded only while recording is on):
``runner.key`` (the key, and new buffers when it changed),
``runner.copy_in`` and ``runner.copy_out`` (the carry's copies, with
their ``bytes``), ``runner.replay`` (each replay, or each direct call,
with its ``k``) and ``runner.capture`` (a warm-up and capture, with its
``k`` and ``pattern``).  The rebuild inside a replay is device work, which
the device's trace names.  The registry counts ``graphs.captures`` and
``graphs.capture_s``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from tisph_tpu_torch.geometry.emitter import count_step, due_step
from tisph_tpu_torch.ops.grid import state_fields
from tisph_tpu_torch.utils.profiling import count, launch_counters, set_launch_counters, span


def _tensors(obj) -> dict[str, torch.Tensor]:
    """A carry leaf's tensor fields by name, in field order."""
    return {n: getattr(obj, n) for n in state_fields(obj)}


def _leaves(carry) -> list:
    """The carry's dataclasses in order, a list element (the shards) flattened."""
    return [x for c in carry for x in (c if isinstance(c, (list, tuple)) else [c])]


def _unflatten(carry, leaves: list) -> tuple:
    """``leaves`` in the structure of ``carry``."""
    it = iter(leaves)
    return tuple([next(it) for _ in c] if isinstance(c, (list, tuple)) else next(it)
                 for c in carry)


class GroupRunner:
    """A solver's R-groups through static buffers, each group one replay
    of a graph captured once per key (see the module)."""

    def __init__(self, solver, capture: bool = True):
        self.solver = solver
        self.capture = capture
        self._base: tuple | None = None  # the key without the group's part
        self._bufs: list[dict[str, torch.Tensor]] = []  # one per carry leaf, then emitter
        self._starts: dict[tuple[int, int], torch.Tensor] = {}  # (slot, emitter) start rows
        # group key -> (graph, the launch counters' rises in its capture); None without capture
        self._graphs: dict[tuple, tuple[torch.cuda.CUDAGraph, dict[str, int]] | None] = {}
        self._pool = None
        self._part = ""  # the part of the group being captured, for errors
        self._bytes = (0, 0)  # the bytes copied in and cloned out by a rollout
        self.captures = 0          # graphs captured so far
        self.capture_seconds = 0.0  # host seconds of their warm-ups and captures
        self.replays = 0  # groups run so far (replays, or direct calls without capture)

    def key(self, carry: tuple, k: int, substep: Callable, emitters=(),
            pattern: tuple | None = None) -> tuple:
        """Everything the captured launches depend on: the field shapes,
        dtypes and devices of the carry and the emitters (capacity, shard
        rows, the number of bodies and batch sizes among them), the
        emitters' quotas (a device room test reads them), the substep, the
        solver's ``_capture_key`` (layout, ``boundary_mode``,
        ``fast_math``, the physics and the grid; the decompositions' rows,
        depths and caps), then the group's part: the emission pattern
        (None without emitters) and the group length k."""
        fields = tuple(
            (type(c).__name__,
             tuple((n, tuple(t.shape), t.dtype, t.device) for n, t in _tensors(c).items()))
            for c in _leaves(carry) + list(emitters))
        quotas = tuple(es.max_particles for es in emitters)
        return (fields, quotas, substep.__name__) + self.solver._capture_key() + (pattern, k)

    def rollout(self, carry: tuple, num_steps: int, R: int, substep: Callable,
                emitters: list | None = None) -> tuple:
        """``num_steps`` substeps of ``carry`` (a bound state, or the list
        of shards, first) in groups of R: the carry copied in, a replay per
        group (R, then the tail), the carry cloned out.  With ``emitters``
        each substep emits, on the schedule of ``SolverBase._groups``, and
        the emitters with their new counters are returned after the carry
        (with ``emit_on_device`` the solver resolves their ``emitted`` and
        the live rows)."""
        solver = self.solver
        ems = list(emitters or ())
        with span("runner.key"):
            base = self.key(carry, 0, substep, ems)[:-2]
            if base != self._base:
                # a new key: new buffers and pool, and no stale graph replays
                self._graphs, self._starts = {}, {}
                self._bufs = [{n: torch.empty_like(t) for n, t in _tensors(c).items()}
                              for c in _leaves(carry) + ems]
                self._pool = torch.cuda.graph_pool_handle() if self.capture else None
                self._base = base
                nbytes = [sum(t.nbytes for t in b.values()) for b in self._bufs]
                self._bytes = (sum(nbytes), sum(nbytes[:len(_leaves(carry))]))
        with span("runner.copy_in", bytes=self._bytes[0]):
            for buf, c in zip(self._bufs, _leaves(carry) + ems):
                for n, t in _tensors(c).items():
                    buf[n].copy_(t)
        n_active = solver._num_particles(carry[0]) if emitters is not None else None
        replays: dict[tuple, int] = {}  # replays per key, settled into the counters at the end
        done = 0
        try:
            while done < num_steps:
                k = min(R, num_steps - done)
                pattern = None
                if emitters is not None:
                    pattern, n_active = self._count(ems, n_active, solver._capacity(carry[0]),
                                                    1 if R == 1 else k, R == 1)
                key = (k, pattern)
                if key not in self._graphs:
                    self._graphs[key] = (self._capture(carry, ems, k, substep, pattern)
                                         if self.capture else None)
                with span("runner.replay", k=k):
                    if self.capture:
                        self._graphs[key][0].replay()
                    else:
                        self._group(self._bufs, carry, ems, k, substep, pattern)
                replays[key] = replays.get(key, 0) + 1
                done += k
        finally:
            self._settle(replays)
        with span("runner.copy_out", bytes=self._bytes[1]):
            leaves = [dataclasses.replace(c, **{n: t.clone() for n, t in buf.items()})
                      for buf, c in zip(self._bufs, _leaves(carry))]
        out = _unflatten(carry, leaves)
        if emitters is None:
            return out
        part = out[0] if solver.emit_on_device else solver._with_live(out[0], n_active)
        return (part,) + out[1:] + (ems,)

    def _settle(self, replays: dict[tuple, int]) -> None:
        """Add each key's replays times what its capture counted to the
        launch counters, once a rollout."""
        self.replays += sum(replays.values())
        if not self.capture:
            return
        for key, n in replays.items():
            for name, c in self._graphs[key][1].items():
                count(name, n * c)

    def _count(self, ems: list, n_active: int, capacity: int, slots: int,
               before: bool) -> tuple[tuple, int]:
        """The host's count of one group's emission slots, as the eager
        loop's ``_maybe_emit`` counts them: advances ``ems`` in place, fills
        the start rows of the batches that fire, and returns the group's
        pattern ``(before, fires per slot)``, None when no batch fires (the
        group is then the plain one), and the new ``num_active``.  With
        ``emit_on_device`` a slot's fires are the due emitters alone."""
        fires = []
        for slot in range(slots):
            row = []
            for e, es in enumerate(ems):
                if self.solver.emit_on_device:
                    fire, ems[e] = due_step(es)
                    row.append(fire)
                    continue
                fire, ems[e] = count_step(es, n_active + es.batch_size <= capacity)
                if fire:
                    start = self._starts.get((slot, e))
                    if start is None:
                        start = self._starts[(slot, e)] = torch.zeros(
                            (), dtype=torch.int64, device=es.seeds_x.device)
                    start.fill_(n_active)  # queued on the stream: no host wait
                    n_active += es.batch_size
                row.append(fire)
            fires.append(tuple(row))
        if not any(any(row) for row in fires):
            return None, n_active
        return (before, tuple(fires)), n_active

    def _group(self, bufs: list, template: tuple, ems: list, k: int, substep: Callable,
               pattern: tuple | None) -> None:
        """The group's body on ``bufs``: emission before the rebuild
        (R = 1), the rebuild, k substeps each after its emission (R > 1),
        then the new carry written back into ``bufs``.  ``template`` gives
        the carry's host fields (``num_active``), which no group reads."""
        solver = self.solver
        n = len(_leaves(template))
        carry = _unflatten(template, [dataclasses.replace(c, **b) for c, b in
                                      zip(_leaves(template), bufs)])
        seeds = [dataclasses.replace(es, **b) for es, b in zip(ems, bufs[n:])]
        before, fires = pattern if pattern is not None else (False, ())

        def emit(carry, slot):
            self._part = f"the emission of slot {slot}"
            part = carry[0]
            for e, fire in enumerate(fires[slot]):
                if fire:
                    part = solver._emit_batch(part, seeds[e], e, self._starts.get((slot, e)))
            return (part,) + tuple(carry[1:])

        if before:
            carry = emit(carry, 0)
        self._part = "the rebuild"
        state, cache = solver._build(carry[0])
        carry = (state,) + tuple(carry[1:])
        for i in range(k):
            if fires and not before:
                carry = emit(carry, i)
            self._part = f"substep {i + 1} of {k}"
            carry = substep(carry, cache)
        self._part = "the write-back"
        for buf, c in zip(bufs, _leaves(carry)):
            for name, t in _tensors(c).items():
                if t is not buf[name]:  # a field the group passed through is in place
                    buf[name].copy_(t)

    def _capture(self, template: tuple, ems: list, k: int, substep: Callable,
                 pattern: tuple | None) -> tuple[torch.cuda.CUDAGraph, dict[str, int]]:
        """Warm up, then capture one group of k substeps on the buffers;
        the graph and the launch counters' rises in the capture."""
        with span("runner.capture", k=k, pattern=pattern):
            t0 = time.perf_counter()
            before = launch_counters()
            dev = self.solver.device
            held = self.solver._inplace()
            try:
                # the warm-up: first uses (device_constant, the kernel library,
                # torch.sort's workspace) happen here, on copies, never in the
                # capture; its results are thrown away, and what it updated in
                # place outside the carry is put back
                saved = [t.clone() for t in held]
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    scratch = [{n: t.clone() for n, t in b.items()} for b in self._bufs]
                    self._group(scratch, template, ems, k, substep, pattern)
                torch.cuda.current_stream(dev).wait_stream(side)
                for t, v in zip(held, saved):
                    t.copy_(v)
                del scratch, saved
                set_launch_counters(before)
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph, pool=self._pool):
                        self._group(self._bufs, template, ems, k, substep, pattern)
                except Exception as e:
                    raise RuntimeError(
                        f"{type(self.solver).__name__}: {self._part} broke the capture of a group "
                        f"of {k} substeps ({type(e).__name__}: {e})") from e
                counted = {name: v - before.get(name, 0)
                           for name, v in launch_counters().items() if v != before.get(name, 0)}
            finally:
                set_launch_counters(before)  # neither the warm-up nor the capture launched
            seconds = time.perf_counter() - t0
            self.captures += 1
            self.capture_seconds += seconds
            count("graphs.captures")
            count("graphs.capture_s", seconds)
            return graph, counted
