"""The readers of the program's spans and counters: each, fed a synthetic
record through a stand-in for ``tisph_tpu_torch.utils.profiling`` in
``sys.modules``, gives the value its file defines, and gives none where
the module is absent, lacks the tracer (a program before it) or recorded
nothing."""

from __future__ import annotations

import dataclasses
import sys
import types

import pytest

from benchmark.cells import load_module
from benchmark.tests import tiny

MODULE = "tisph_tpu_torch.utils.profiling"
READERS = ("replay_ms_per_step", "carry_ms_per_step", "port_launches_per_step",
           "dump_wait_ms_p50", "dump_copy_ms_p50", "capture_s", "build_s")


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    attrs: dict


def _ms(name, ms, parent=0, call=1, **attrs):
    return Span(name, 0, int(ms * 1e6), parent, call, attrs)


# two 400-step calls of 200 groups at R=2, one with a 5-step call's frame
# dumped after it; times in ms
RECORD = [
    _ms("solver.rollout", 50.0, parent=-1, steps=400, R=2, launches=1800, replays=200,
        captures=0),
    _ms("runner.key", 0.02), _ms("runner.copy_in", 0.05, bytes=1000),
    *[_ms("runner.replay", 0.2, k=2) for _ in range(200)],
    _ms("runner.copy_out", 0.03, bytes=1000),
    _ms("solver.rollout", 50.0, parent=-1, call=2, steps=400, R=2, launches=1800,
        replays=200, captures=0),
    _ms("runner.key", 0.04, parent=204, call=2),
    *[_ms("runner.replay", 0.3, parent=204, call=2, k=2) for _ in range(200)],
    _ms("state.to_host", 3.0, parent=-1, call=3, bytes=11_700_000, fields=9),
    _ms("state.to_host.wait", 2.0, parent=406, call=3),
    _ms("state.to_host.copy", 1.0, parent=406, call=3),
    _ms("state.to_host", 4.0, parent=-1, call=4, bytes=11_700_000, fields=9),
    _ms("state.to_host.wait", 2.5, parent=409, call=4),
    _ms("state.to_host.copy", 1.5, parent=409, call=4),
    _ms("state.to_host", 4.0, parent=-1, call=5, bytes=11_700_000, fields=9),
    _ms("state.to_host.wait", 3.5, parent=412, call=5),
    _ms("state.to_host.copy", 0.5, parent=412, call=5),
]
assert all(RECORD[s.parent].call == s.call for s in RECORD if s.parent >= 0)
COUNTERS = {"graphs.captures": 2, "graphs.capture_s": 1.25, "build.s": 9.5}
EXPECTED = {
    "replay_ms_per_step": (200 * 0.2 + 200 * 0.3) / 800,
    "carry_ms_per_step": (0.02 + 0.05 + 0.03 + 0.04) / 800,
    "port_launches_per_step": 3600 / 800,
    "dump_wait_ms_p50": 2.5,
    "dump_copy_ms_p50": 1.0,
    "capture_s": 1.25,
    "build_s": 9.5,
}


def _reader(name):
    return load_module(tiny.REPO / "benchmark" / "metrics" / f"{name}.py",
                       f"test_reader_{name}").read


def _program(record, counters):
    return types.SimpleNamespace(recorded=lambda: list(record), counters=lambda: dict(counters))


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


def test_every_reader_has_its_entry():
    import json

    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "host_clock" and entries[name]["workloads"]
