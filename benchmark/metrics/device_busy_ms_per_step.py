"""Device ms a step in which an operation ran (the union of the
profiler's device intervals), over the profiled copy of the traced
episode."""


def read(rec, variant):
    return rec.device.busy_s * 1e3 / rec.steps if rec.device is not None else None
