"""The whole step's share of its roofline, in %: the least time of a
step's work on the card (``benchmark.work.step_bound_ms``: the two pair
sums, the rebuild, the two row ops, each bound by bytes or operations,
with the pairs inside h averaged over states spread over the episode)
over the device's busy ms a step."""


def read(rec, variant):
    if rec.device is None or rec.bound_ms_per_step is None:
        return None
    return 100.0 * rec.bound_ms_per_step / (rec.device.busy_s * 1e3 / rec.steps)
