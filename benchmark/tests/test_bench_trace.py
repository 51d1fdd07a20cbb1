"""``benchmark.trace.read_events``: the busy union, the traced window that
holds it, and the idle gaps by host span, on made-up events."""

from __future__ import annotations

import pytest

from benchmark import trace
from benchmark.metrics import device_idle_share


def test_busy_is_the_union_and_the_window_spans_everything():
    ops = [(10.0, 30.0, "a"), (20.0, 40.0, "b"), (60.0, 70.0, "a")]
    spans = [(0.0, 45.0, "advance"), (50.0, 80.0, "health_read")]
    t = trace.read_events(ops, spans)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.window_s == pytest.approx(80e-6)
    assert t.ops == 3
    assert t.by_name == pytest.approx({"a": 30e-6, "b": 20e-6})
    assert t.idle_by_span == pytest.approx({"health_read": 20e-6})


@pytest.mark.parametrize("spans", [[], [(5.0, 6.0, "episode_start")]])
def test_a_device_paced_window_never_reads_busier_than_its_length(spans):
    # back-to-back operations: the device never idles, and the window ends
    # with the last of them where no host span outlasts it
    ops = [(k * 10.0, (k + 1) * 10.0, "k") for k in range(1, 100)]
    t = trace.read_events(ops, spans)
    assert 0 < t.busy_s <= t.window_s
    rec = type("Rec", (), {"device": t})()
    assert device_idle_share.read(rec, None) >= 0.0


def test_no_device_operation_is_an_error():
    with pytest.raises(RuntimeError):
        trace.read_events([], [(0.0, 1.0, "advance")])
