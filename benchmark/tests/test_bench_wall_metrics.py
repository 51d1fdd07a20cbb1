"""The readers of what a bind and the sweeps' row tallies record:
``bind_s`` from the program's counters and ``sweep_rows_per_fluid_row``
from its ``solver.rollout`` spans, each fed through a stand-in for
``tisph_tpu_torch.utils.profiling`` in ``sys.modules``; none where the
module is absent, lacks the tracer (a program before it) or recorded
nothing."""

from __future__ import annotations

import json
import sys
import types

import pytest

from benchmark.cells import load_module
from benchmark.tests import tiny
from benchmark.tests.test_bench_program_spans import MODULE, _ms, _program

READERS = ("bind_s", "sweep_rows_per_fluid_row")
N, FLUID = 739_024, 676_500  # spheric2's rows (capacity) and fluid rows

# two 400-step calls at R=2 and a 200-step one, each sweeping every row
# twice a step; a health read between them
RECORD = [
    _ms("solver.rollout", 50.0, parent=-1, call=c, steps=k, R=2, launches=9 * k // 2,
        sweep_rows=2 * N * k, fluid_rows=FLUID, boundary_rows=62_521, replays=k // 2,
        captures=0)
    for c, k in ((1, 400), (2, 400), (4, 200))
]
RECORD.insert(2, _ms("solver.metrics", 0.1, parent=-1, call=3))
COUNTERS = {"bind.calls": 2, "bind.s": 0.006, "bind.boundary_rows": 2 * 62_521,
            "graphs.captures": 2, "graphs.capture_s": 1.25, "build.s": 9.5}
EXPECTED = {"bind_s": 0.003, "sweep_rows_per_fluid_row": 2 * N / FLUID}


def _reader(name):
    return load_module(tiny.REPO / "benchmark" / "metrics" / f"{name}.py",
                       f"test_wall_reader_{name}").read


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_record(name, monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, _program(RECORD, COUNTERS))
    assert _reader(name)(None, None) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_a_record(name, monkeypatch):
    read = _reader(name)
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert read(None, None) is None
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace())  # no tracer
    assert read(None, None) is None
    monkeypatch.setitem(sys.modules, MODULE, _program([], {}))
    assert read(None, None) is None


def test_rollouts_of_a_program_before_the_row_tallies_give_none(monkeypatch):
    """A parent's ``solver.rollout`` spans carry ``launches`` but neither
    ``sweep_rows`` nor ``fluid_rows``; its counters have no ``bind.*``."""
    old = [_ms("solver.rollout", 50.0, parent=-1, steps=400, R=2, launches=1800, replays=200,
               captures=0)]
    monkeypatch.setitem(sys.modules, MODULE,
                        _program(old, {"graphs.captures": 1, "graphs.capture_s": 0.5}))
    for name in READERS:
        assert _reader(name)(None, None) is None


def test_entries_name_their_cells():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert entries["bind_s"]["source"] == "program_counter"
    assert entries["bind_s"]["workloads"] == ["spheric2.run"]
    assert entries["sweep_rows_per_fluid_row"]["source"] == "program_span"
    assert set(entries["sweep_rows_per_fluid_row"]["workloads"]) == {
        "demo_3d.run", "demo_3d.frames", "dam_1m.run", "spheric2.run"}
