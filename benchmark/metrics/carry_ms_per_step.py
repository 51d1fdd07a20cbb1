"""Host ms a step in the graph runner's carry: its ``runner.key``,
``runner.copy_in`` and ``runner.copy_out`` spans (the key, the carry
copied into the graphs' buffers, the clone out; program spans of
``tisph_tpu_torch.utils.profiling`` in the traced run's profiled episode)
over the steps its ``solver.rollout`` spans hold; none where the program
recorded no such span."""

import sys

CARRY = ("runner.key", "runner.copy_in", "runner.copy_out")


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    spans = prof.recorded() if hasattr(prof, "recorded") else []
    steps = sum(s.attrs.get("steps", 0) for s in spans if s.name == "solver.rollout")
    ns = [s.end_ns - s.start_ns for s in spans if s.name in CARRY]
    return sum(ns) * 1e-6 / steps if ns and steps else None
