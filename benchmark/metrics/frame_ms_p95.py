"""The 95th percentile of the window's frame times, each from its
``advance`` call to its host arrays (host clock); none without a dump."""

import statistics


def read(rec, variant):
    if len(rec.frame_ms) < 2:
        return None
    return statistics.quantiles(rec.frame_ms, n=100, method="inclusive")[94]
