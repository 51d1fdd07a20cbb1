"""Particle-steps per second: every particle-step of the window over the
window's wall time, from its start to the device's finish (host clock)."""


def read(rec, variant):
    return rec.particles * rec.steps / rec.wall_s if rec.wall_s > 0 else None
