"""One R-group, one CUDA graph replay: the port's counterpart of
``tisph_tpu``'s one-dispatch rollout (``solver_base.py:8-12``, ``:277-326``,
a jitted ``lax.fori_loop`` over groups; ``wcsph_rigid.py:143-186`` for the
coupled step).

:class:`GroupRunner` owns a solver's static carry (the tensor fields of
the ``SimState``, and of the ``RigidState`` on the coupled path), one
``torch.cuda.CUDAGraph`` per group length k (R, and the tail ``num_steps
% R``) and one memory pool the graphs share.  A captured group is the
eager group's body: ``_build`` (cell ids, ``torch.sort``, the rebuild
kernel) and k substeps, which end by writing the new carry back into the
static buffers inside the graph, so replays chain with no host step
between them.  A rollout copies the carry in once, replays its groups and
clones the carry out once, with no synchronisation.

Where a capture could go wrong, and what the runner does about it:

- first use: ``ops/consts.py``'s ``device_constant`` fills its cache with
  a host-to-device copy, ``ops/cuda/build.py``'s ``load`` may run
  ``nvcc`` and ``torch.sort`` sizes its workspace on first call.  Before
  each capture one warm-up group runs eagerly on a side stream, on
  throwaway copies of the buffers, so the state never advances twice;
  both caches also refuse a first fill inside a capture;
- streams: every kernel wrapper reads ``torch.cuda.current_stream()`` at
  call time, which inside ``torch.cuda.graph`` is the capture stream;
- failure: a capture that fails raises, naming the part of the group
  that broke it (no eager fallback);
- aliasing: graph tensors live in the pool and the next replay rewrites
  the buffers, so the carry a rollout returns is a clone and no group
  cache leaves the graph;
- launch counters: the wrappers count launches in Python, and a replay
  makes no Python call, so the runner records what a capture counted and
  adds it at every replay;
- bitwise: a replay runs the eager group's kernels with the same launch
  shapes in the same order (``launch_shape`` reads only the row count),
  so it equals the eager group bitwise, not within a tolerance.

``capture=False`` runs the same plumbing (copy in, group on the buffers,
write back, tail group, copy out) with a direct call of the group in
place of each replay: the CPU tests drive it so.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.ops.grid import state_fields

# every wrapper's launch counters (``launches``, and ``part_launches``
# where it has them): a replay adds what its capture counted
_COUNTERS = tuple(
    (w, c)
    for w in (cuda_bounds.sort_and_bound, cuda_bounds.csr_bounds_sorted,
              cuda_sweeps.density_sweep, cuda_sweeps.force_sweep, cuda_sweeps.bvol_sweep,
              cuda_sweeps.force_react_sweep, cuda_sweeps.reaction_sweep,
              cuda_sweeps.density_sweep_linear, cuda_sweeps.force_sweep_linear)
    for c in ("launches", "part_launches") if hasattr(w, c)
)


def _read_counters() -> list[int]:
    return [getattr(w, c) for w, c in _COUNTERS]


def _set_counters(values: list[int]) -> None:
    for (w, c), v in zip(_COUNTERS, values):
        setattr(w, c, v)


def _tensors(obj) -> dict[str, torch.Tensor]:
    """A carry element's tensor fields by name, in field order."""
    return {n: getattr(obj, n) for n in state_fields(obj)}


class GroupRunner:
    """A solver's R-groups through static buffers, each group one replay
    of a graph captured once per key (see the module)."""

    def __init__(self, solver, capture: bool = True):
        self.solver = solver
        self.capture = capture
        self._base: tuple | None = None  # the key without k of the buffers
        self._bufs: tuple[dict[str, torch.Tensor], ...] = ()
        self._graphs: dict[int, tuple[torch.cuda.CUDAGraph, list[int]]] = {}
        self._pool = None
        self._part = ""  # the part of the group being captured, for errors
        self.captures = 0          # graphs captured so far
        self.capture_seconds = 0.0  # host seconds of their warm-ups and captures

    def key(self, carry: tuple, k: int, substep: Callable) -> tuple:
        """Everything the captured launches depend on: the carry's field
        shapes, dtypes and devices (capacity and the number of bodies among
        them), the substep, the layout, ``boundary_mode``, ``fast_math``,
        the physics and the grid, and last the group length k."""
        s = self.solver
        fields = tuple(
            (type(c).__name__,
             tuple((n, tuple(t.shape), t.dtype, t.device) for n, t in _tensors(c).items()))
            for c in carry)
        return (fields, substep.__name__, s.layout, s.boundary_mode, s.fast_math, s.params,
                s.spec, k)

    def rollout(self, carry: tuple, num_steps: int, R: int, substep: Callable) -> tuple:
        """``num_steps`` substeps of ``carry`` (a bound state first) in
        groups of R: the carry copied in, a replay per group (R, then the
        tail), the carry cloned out."""
        base = self.key(carry, 0, substep)[:-1]
        if base != self._base:
            # a new key: new buffers and pool, and no stale graph replays
            self._graphs = {}
            self._bufs = tuple({n: torch.empty_like(t) for n, t in _tensors(c).items()}
                               for c in carry)
            self._pool = torch.cuda.graph_pool_handle() if self.capture else None
            self._base = base
        for buf, c in zip(self._bufs, carry):
            for n, t in _tensors(c).items():
                buf[n].copy_(t)
        done = 0
        while done < num_steps:
            k = min(R, num_steps - done)
            if not self.capture:
                self._group(self._bufs, carry, k, substep)
            else:
                if k not in self._graphs:
                    self._capture(carry, k, substep)
                graph, counted = self._graphs[k]
                graph.replay()
                _set_counters([a + b for a, b in zip(_read_counters(), counted)])
            done += k
        return tuple(dataclasses.replace(c, **{n: t.clone() for n, t in buf.items()})
                     for buf, c in zip(self._bufs, carry))

    def _group(self, bufs: tuple, template: tuple, k: int, substep: Callable) -> None:
        """The group's body on ``bufs``: rebuild, k substeps, then the new
        carry written back into ``bufs``.  ``template`` gives the carry's
        host fields (``num_active``), which no group reads."""
        solver = self.solver
        carry = tuple(dataclasses.replace(c, **b) for c, b in zip(template, bufs))
        self._part = "the rebuild"
        state, cache = solver._build(carry[0])
        carry = (state,) + tuple(carry[1:])
        for i in range(k):
            self._part = f"substep {i + 1} of {k}"
            carry = substep(carry, cache)
        self._part = "the write-back"
        for buf, c in zip(bufs, carry):
            for n, t in _tensors(c).items():
                if t is not buf[n]:  # a field the group passed through is in place
                    buf[n].copy_(t)

    def _capture(self, template: tuple, k: int, substep: Callable) -> None:
        """Warm up, then capture one group of k substeps on the buffers."""
        t0 = time.perf_counter()
        before = _read_counters()
        dev = self.solver.device
        try:
            # the warm-up: first uses (device_constant, the kernel library,
            # torch.sort's workspace) happen here, on copies, never in the
            # capture; its results are thrown away
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                scratch = tuple({n: t.clone() for n, t in b.items()} for b in self._bufs)
                self._group(scratch, template, k, substep)
            torch.cuda.current_stream(dev).wait_stream(side)
            del scratch
            _set_counters(before)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    self._group(self._bufs, template, k, substep)
            except Exception as e:
                raise RuntimeError(
                    f"{type(self.solver).__name__}: {self._part} broke the capture of a group "
                    f"of {k} substeps ({type(e).__name__}: {e})") from e
            counted = [a - b for a, b in zip(_read_counters(), before)]
        finally:
            _set_counters(before)  # neither the warm-up nor the capture launched
        self._graphs[k] = (graph, counted)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
