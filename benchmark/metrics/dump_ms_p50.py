"""The median ms of a frame's dump, ``state_to_host`` (host clock), over
the traced run's unprofiled episode; none without a dump."""

import statistics


def read(rec, variant):
    return statistics.median(rec.dump_ms) if rec.dump_ms else None
