"""Host ms a step inside the graph runner's replays: the program's
``runner.replay`` spans (``tisph_tpu_torch.utils.profiling``, recorded in
the traced run's profiled episode) over the steps its ``solver.rollout``
spans hold; none where the program recorded no such span."""

import sys


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    spans = prof.recorded() if hasattr(prof, "recorded") else []
    steps = sum(s.attrs.get("steps", 0) for s in spans if s.name == "solver.rollout")
    ns = [s.end_ns - s.start_ns for s in spans if s.name == "runner.replay"]
    return sum(ns) * 1e-6 / steps if ns and steps else None
