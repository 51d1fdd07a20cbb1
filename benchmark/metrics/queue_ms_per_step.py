"""Host ms a step from an ``advance`` call to its return (the graph
runner's time to queue), the mean over the traced run's unprofiled
episode."""

import statistics


def read(rec, variant):
    return statistics.fmean(rec.queue_ms) if rec.queue_ms else None
