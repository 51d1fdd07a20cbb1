"""The device's idle share, in %: 1 - its busy seconds in the profiled
episode over the wall seconds of the same episode run unprofiled just
before (the profiler's own host cost never enters the wall); negative
where busy exceeds that wall."""


def read(rec, variant):
    return None if rec.device is None else 100.0 * (1.0 - rec.device.busy_s / rec.wall_s)
