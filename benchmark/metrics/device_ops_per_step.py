"""Device operations (kernels, copies, fills) a step, counted in the
profiled copy of the traced episode."""


def read(rec, variant):
    return rec.device.ops / rec.steps if rec.device is not None else None
