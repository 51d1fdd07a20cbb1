"""The port's tracer (``tisph_tpu_torch.utils.profiling``): spans at the
layer boundaries, recorded only while recording is on, stamped on the
profiler's clock, and the launch counters settled once a call.

On the CPU:

- with recording off, an eager rollout, a ``GroupRunner(capture=False)``
  rollout, the dump and the health read record nothing and call no
  profiler API (``record_function`` patched to raise), and span sites
  keep no memory;
- with ``recording()`` on, the span tree of a ``capture=False`` rollout of
  n steps at R: one ``solver.rollout``, then ``runner.key``,
  ``runner.copy_in``, ceil(n/R) ``runner.replay`` and ``runner.copy_out``
  under it, in one call, with the carry's bytes; the eager loop's
  ``solver.group`` spans; ``state.to_host`` with its bytes;
- a ``torch.profiler`` session turns recording on and its end turns it
  off; a span and a ``record_function`` range opened around the same
  call agree on the profiler's ``start_ns`` within 1 ms;
- ``profiling.trace()`` writes the spans into ``trace.json`` on the
  file's time base;
- a bind is one ``solver.bind`` span with its rows, fluid rows and
  boundary rows, and adds to the counters ``bind.calls``, ``bind.s`` and
  ``bind.boundary_rows``; a pure-fluid bind sums no boundary volume; a
  ``solver.rollout`` span carries the last bind's fluid and boundary rows;
  a launch through ``ops.cuda.build.launch`` counts ``launches.<wrapper>``
  and, on a sweep, its ``part_launches`` and ``rows`` in the registry;
- the graph runner works on whatever launch counters the registry holds:
  a capture (``torch.cuda``'s graph calls patched to stand-ins) takes back
  what its warm-up and capture counted of a counter no module names, a
  rollout's end adds replays times the captured rises, and ``graphs.py``
  imports nothing from ``ops.cuda``.

Marked ``cuda`` (skipped here): after graphed rollouts the launch
counters rose as the eager rollouts' did, and ``solver.rollout``'s
``launches`` is that rise; a V2 rollout's ``sweep_rows`` is two sweeps of
every row a step.
"""

import ast
import contextlib
import json
import math
import tracemalloc
import types

import pytest
import torch

import tisph_tpu_torch as pt
from tisph_tpu_torch.models import graphs
from tisph_tpu_torch.models.graphs import GroupRunner
from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.ops.grid import state_fields
from tisph_tpu_torch.utils import profiling

torch.set_num_threads(2)

RAW = {
    "configuration": {"dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [1.0, 1.0],
                      "particleRadius": 0.02, "density0": 1000,
                      "gravitation": [0.0, -9.81], "c_s": 88.5},
    "rigidBodies": [],
    "fluidBlocks": [{"start": [0.3, 0.1], "end": [0.5, 0.3], "velocity": [0.0, -2.0],
                     "density": 1000.0, "color": [50, 100, 200]}],
}


# RAW on a floor of static boundary rows, two layers at the diameter
RAW_WALLS = RAW | {"boundaryBlocks": [{"start": [0.1, 0.02], "end": [0.9, 0.07]}]}


def _solver(R=2, legacy=False, device="cpu", raw=RAW):
    scene = pt.scene_from_dict(raw)
    cls = pt.WCSPHLegacy if legacy else pt.WCSPH
    solver = cls(scene, device=device, resort_every=R)
    return solver, solver.bind(pt.build_state(scene, device=device))


def _direct(solver):
    """The graph path's plumbing with a direct call in place of each replay."""
    solver.graphs = True
    solver._runner = GroupRunner(solver, capture=False)
    return solver._runner


def _cleared():
    with profiling.recording():
        pass
    assert profiling.recorded() == []


def _raise(*a, **k):
    raise AssertionError("the tracer called a profiler API")


def test_off_records_nothing_and_calls_no_profiler_api(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    _cleared()
    assert not profiling.is_recording()
    solver, state = _solver(R=2)
    out = solver.rollout(state, 3)  # the eager loop
    _direct(solver)
    out = solver.rollout(out, 3)
    pt.state_to_host(out)
    solver.metrics(out)
    assert profiling.recorded() == []


def test_off_span_site_keeps_nothing():
    """20,000 span sites with recording off hold no more memory, at the
    end or at the peak, than one: nothing is kept per span."""
    _cleared()
    for _ in range(10):  # warm the code path
        with profiling.span("runner.replay", k=2):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(20_000):
            with profiling.span("runner.replay", k=2) as sp:
                assert sp is None
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before <= 64 and peak - before < 1024
    assert profiling.recorded() == []


@pytest.mark.parametrize("n,R", [(5, 2), (4, 2), (3, 1), (7, 3)])
def test_span_tree_of_a_direct_rollout(n, R):
    solver, state = _solver(R=R)
    _direct(solver)
    with profiling.recording():
        solver.rollout(state, n)
    spans = profiling.recorded()
    groups = math.ceil(n / R)
    assert [s.name for s in spans] == (["solver.rollout", "runner.key", "runner.copy_in"]
                                       + ["runner.replay"] * groups + ["runner.copy_out"])
    root = spans[0]
    assert root.parent == -1 and root.attrs["steps"] == n and root.attrs["R"] == R
    assert root.attrs["replays"] == groups and root.attrs["captures"] == 0
    assert root.attrs["launches"] == 0  # the CPU runs the plain sweeps
    assert all(s.parent == 0 and s.call == root.call for s in spans[1:])
    assert [s.attrs["k"] for s in spans if s.name == "runner.replay"] == (
        [R] * (n // R) + ([n % R] if n % R else []))
    nbytes = sum(getattr(state, f).nbytes for f in state_fields(state))
    assert spans[2].attrs["bytes"] == nbytes and spans[-1].attrs["bytes"] == nbytes
    for s in spans:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    replays = [s for s in spans if s.name == "runner.replay"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(replays, replays[1:]))


def test_calls_get_their_own_ids_and_sessions_replace_the_record():
    solver, state = _solver(R=1, legacy=True)
    _direct(solver)
    with profiling.recording():
        out = solver.rollout(state, 2)
        solver.step(out)
    spans = profiling.recorded()
    roots = [s for s in spans if s.parent == -1]
    assert [r.name for r in roots] == ["solver.rollout", "solver.rollout"]
    assert [r.attrs["steps"] for r in roots] == [2, 1] and roots[0].call != roots[1].call
    assert all(s.call == spans[s.parent].call for s in spans if s.parent >= 0)
    with profiling.recording():
        solver.metrics(out)
    assert [s.name for s in profiling.recorded()] == ["solver.metrics"]


def test_eager_loop_groups():
    solver, state = _solver(R=2)
    with profiling.recording():
        solver.rollout(state, 5)
    spans = profiling.recorded()
    assert [s.name for s in spans] == ["solver.rollout"] + ["solver.group"] * 3
    assert [s.attrs["k"] for s in spans[1:]] == [2, 2, 1]
    assert spans[0].attrs["replays"] == 0 and all(s.parent == 0 for s in spans[1:])


def test_state_to_host_span():
    solver, state = _solver()
    with profiling.recording():
        host = pt.state_to_host(state)
    spans = profiling.recorded()
    assert [s.name for s in spans] == ["state.to_host", "state.to_host.copy"]  # no wait on CPU
    assert spans[1].parent == 0
    fields = {k: v for k, v in host.items() if k != "num_active"}
    assert spans[0].attrs == {"bytes": sum(a.nbytes for a in fields.values()),
                              "fields": len(fields)}


def test_a_profiler_session_records_on_its_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    _cleared()
    solver, state = _solver()
    assert not profiling.is_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.is_recording()
        with record_function("warm-up"):
            torch.ones(3).sum()
        with profiling.span("probe") as sp, record_function("probe_range"):
            solver.metrics(state)
    assert not profiling.is_recording()
    names = [s.name for s in profiling.recorded()]
    assert names == ["probe", "solver.metrics"]
    assert profiling.recorded()[1].parent == 0
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "probe_range"]
    assert len(starts) == 1 and abs(starts[0] - sp.start_ns) < 1_000_000
    # spans opened with recording off end the session: the next one replaces it
    solver.metrics(state)
    with profile(activities=[ProfilerActivity.CPU]):
        solver.metrics(state)
    assert [s.name for s in profiling.recorded()] == ["solver.metrics"]


def test_trace_writes_the_spans_on_the_files_base(tmp_path):
    solver, state = _solver()
    _direct(solver)
    with profiling.trace(str(tmp_path)):
        solver.rollout(state, 2)
    spans = profiling.recorded()
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = int(doc["baseTimeNanoseconds"])
    events = [e for e in doc["traceEvents"] if e.get("cat") == "tisph"]
    assert [e["name"] for e in events] == [s.name for s in spans]
    assert spans and spans[0].name == "solver.rollout"
    for e, s in zip(events, spans):
        assert e["ph"] == "X" and e["ts"] == pytest.approx((s.start_ns - base) / 1e3, abs=1e-3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3, abs=1e-3)
        assert e["args"]["parent"] == s.parent
    tids = {e["tid"] for e in events}
    assert len(tids) == 1 and not tids & {e.get("tid") for e in doc["traceEvents"]
                                          if e.get("cat") not in ("tisph", None)}


def test_counters_add_and_copy():
    before = profiling.counters()
    profiling.count("test.events")
    profiling.count("test.events", 2)
    profiling.count("test.s", 0.5)
    after = profiling.counters()
    assert after["test.events"] - before.get("test.events", 0) == 3
    assert after["test.s"] - before.get("test.s", 0) == 0.5
    after["test.events"] = -1
    assert profiling.counters()["test.events"] != -1


def test_a_bind_with_boundary_rows_is_traced():
    scene = pt.scene_from_dict(RAW_WALLS)
    state = pt.build_state(scene, device="cpu")
    fluid, walls = int(state.fluid_mask.sum()), int(state.boundary_mask.sum())
    assert fluid > 0 and walls > 0
    solver = pt.WCSPH(scene, device="cpu", resort_every=2)
    before = profiling.counters()
    with profiling.recording():
        bound = solver.bind(state)
    after = profiling.counters()
    assert [s.name for s in profiling.recorded()] == ["solver.bind"]
    assert profiling.recorded()[0].attrs == {"rows": state.capacity, "fluid_rows": fluid,
                                             "boundary_rows": walls}
    assert after["bind.calls"] - before.get("bind.calls", 0) == 1
    assert after["bind.s"] - before.get("bind.s", 0) > 0
    assert after["bind.boundary_rows"] - before.get("bind.boundary_rows", 0) == walls
    assert not torch.equal(bound.volume, state.volume)  # the Akinci volumes


def test_a_pure_fluid_bind_sums_no_boundary_volume(monkeypatch):
    monkeypatch.setattr(cuda_sweeps, "bvol_sweep", _raise)
    before = profiling.counters()
    solver, state = _solver()
    after = profiling.counters()
    assert after["bind.calls"] - before.get("bind.calls", 0) == 1
    assert after["bind.boundary_rows"] - before.get("bind.boundary_rows", 0) == 0
    assert solver._bind_rows == {"fluid_rows": state.num_active, "boundary_rows": 0}


@pytest.mark.parametrize("graphed", [False, True])
def test_a_rollout_carries_the_bound_rows(graphed):
    solver, state = _solver(raw=RAW_WALLS)
    if graphed:
        _direct(solver)
    with profiling.recording():
        solver.rollout(state, 3)
    root = profiling.recorded()[0]
    assert root.name == "solver.rollout"
    assert root.attrs["fluid_rows"] == int(state.fluid_mask.sum())
    assert root.attrs["boundary_rows"] == int(state.boundary_mask.sum()) > 0
    assert root.attrs["sweep_rows"] == 0  # the CPU runs the plain sweeps


def test_a_launch_adds_its_rows(monkeypatch):
    """``build.launch`` with the library, the device and the stream stood
    in for: the entry gets the arguments and the stream, and the launch
    counts in the registry."""
    monkeypatch.setattr(profiling, "_counters", dict(profiling._counters))  # put back after
    calls = []
    lib = types.SimpleNamespace(tisph_sweep=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=7))
    before = profiling.counters()
    rows0 = profiling.sweep_rows()
    build.launch("force_sweep", "tisph_sweep", "cuda", 1, 2, part_launches=0, rows=1000)
    build.launch("force_sweep", "tisph_sweep", "cuda", 3, part_launches=1, rows=24)
    after = profiling.counters()
    assert calls == [(1, 2, 7), (3, 7)]
    assert [after[f"{c}.force_sweep"] - before.get(f"{c}.force_sweep", 0)
            for c in ("launches", "part_launches", "rows")] == [2, 1, 1024]
    assert profiling.sweep_rows() - rows0 == 1024
    assert profiling.launches() - sum(v for k, v in before.items()
                                      if k.startswith("launches.")) == 2


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: a replay runs nothing."""

    replays = 0

    def replay(self):
        _Graph.replays += 1


def _stand_in_graphs(monkeypatch):
    """``torch.cuda``'s stream and graph calls of ``GroupRunner._capture``
    as no-ops, so the runner's capture path runs on the CPU."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    for name, fn in (("graph_pool_handle", lambda: None), ("Stream", lambda dev: stream),
                     ("current_stream", lambda dev=None: stream),
                     ("stream", lambda s: contextlib.nullcontext()), ("CUDAGraph", _Graph),
                     ("graph", lambda g, pool=None: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fn)


def test_a_capture_takes_back_and_settles_any_launch_counter(monkeypatch):
    """A counter no module outside the test names, counted by every
    substep: the warm-ups' and captures' counts are taken back, and the
    rollout's end adds replays times what each capture counted, so the
    counters and the ``solver.rollout`` span read as an eager run's."""
    monkeypatch.setattr(profiling, "_counters", dict(profiling._counters))  # put back after
    _stand_in_graphs(monkeypatch)
    solver, state = _solver(R=2)
    plain = solver._substep

    def substep(carry, cache):
        profiling.count("launches.made_up_kernel")
        profiling.count("rows.made_up_kernel", 100)
        return plain(carry, cache)

    solver._substep = substep
    solver.graphs = True
    solver._runner = runner = GroupRunner(solver)
    _Graph.replays = 0
    with profiling.recording():
        solver.rollout(state, 7)  # groups of 2, 2, 2, then 1
    counted = profiling.counters()
    assert runner.captures == 2 and _Graph.replays == 4
    assert runner._graphs[(2, None)][1] == {"launches.made_up_kernel": 2,
                                            "rows.made_up_kernel": 200}
    assert runner._graphs[(1, None)][1] == {"launches.made_up_kernel": 1,
                                            "rows.made_up_kernel": 100}
    assert counted["launches.made_up_kernel"] == 7
    assert counted["rows.made_up_kernel"] == 700
    root = profiling.recorded()[0]
    assert root.name == "solver.rollout"
    assert root.attrs["launches"] == 7 and root.attrs["sweep_rows"] == 700
    assert root.attrs["captures"] == 2 and root.attrs["replays"] == 4


def test_settle_adds_replays_times_captured(monkeypatch):
    monkeypatch.setattr(profiling, "_counters", dict(profiling._counters))  # put back after
    solver, _ = _solver(R=2)
    runner = GroupRunner(solver)
    runner._graphs[(2, None)] = (None, {"launches.made_up_kernel": 3,
                                        "part_launches.made_up_kernel": 1})
    runner._graphs[(1, None)] = (None, {"launches.made_up_kernel": 2})
    before = profiling.launches()
    runner._settle({(2, None): 5, (1, None): 1})
    counted = profiling.counters()
    assert counted["launches.made_up_kernel"] == 17
    assert counted["part_launches.made_up_kernel"] == 5
    assert profiling.launches() - before == 17 and runner.replays == 6


def test_the_graph_runner_imports_no_kernel_module():
    tree = ast.parse(open(graphs.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names if m.startswith("tisph_tpu_torch.ops.cuda")]
    assert not hasattr(graphs, "_COUNTERS")


def _counts():
    return profiling.launch_counters()


@pytest.mark.cuda
@pytest.mark.parametrize("legacy", [False, True])
def test_graph_launch_counters_settle_as_eager(legacy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    R = 1 if legacy else 2
    eager, state = _solver(R=R, legacy=legacy, device="cuda")
    eager.graphs = False
    graphed, gstate = _solver(R=R, legacy=legacy, device="cuda")
    assert graphed.graphs
    rises = {}
    for name, solver, st in (("eager", eager, state), ("graph", graphed, gstate)):
        solver.rollout(st, 3)  # kernels built, graphs captured
        c0 = _counts()
        with profiling.recording():
            solver.rollout(st, 7)
            solver.step(st)
        torch.cuda.synchronize()
        rises[name] = {k: v - c0.get(k, 0) for k, v in _counts().items() if v != c0.get(k, 0)}
        launched = sum(r for k, r in rises[name].items() if k.startswith("launches."))
        roots = [s for s in profiling.recorded() if s.name == "solver.rollout"]
        assert sum(s.attrs["launches"] for s in roots) == launched > 0
        assert not [s for s in profiling.recorded() if s.name == "runner.capture"]
    assert rises["graph"] == rises["eager"]


@pytest.mark.cuda
@pytest.mark.parametrize("raw", [RAW, RAW_WALLS], ids=["fluid", "walls"])
def test_a_v2_rollout_sweeps_every_row_twice_a_step(raw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    solver, state = _solver(R=2, device="cuda", raw=raw)
    assert solver.graphs
    solver.rollout(state, 3)  # kernels built, graphs captured
    with profiling.recording():
        solver.rollout(state, 7)
    torch.cuda.synchronize()
    root = profiling.recorded()[0]
    assert root.name == "solver.rollout" and root.attrs["replays"] == 4
    assert root.attrs["sweep_rows"] == 2 * state.capacity * 7
