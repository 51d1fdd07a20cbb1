"""The device's idle share, in %: 1 - its busy seconds over the traced
window's seconds, both from the profiled copy of the traced episode, on
the profiler's timeline (``device.busy_s`` and ``device.window_s``); the
profiler's own host cost lengthens the window where the host paces the
device."""


def read(rec, variant):
    return None if rec.device is None else 100.0 * (1.0 - rec.device.busy_s / rec.device.window_s)
