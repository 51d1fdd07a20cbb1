"""The port's own kernel launches a step: the ``launches`` of the
program's ``solver.rollout`` spans (``tisph_tpu_torch.utils.profiling``,
the rise of its kernel wrappers' launch counters in each call, replays
included) over their ``steps``, in the traced run's profiled episode.
``device_ops_per_step`` less this is PyTorch's own operations; none where
the program recorded no such span."""

import sys


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    spans = prof.recorded() if hasattr(prof, "recorded") else []
    calls = [s.attrs for s in spans if s.name == "solver.rollout" and "launches" in s.attrs]
    steps = sum(a.get("steps", 0) for a in calls)
    return sum(a["launches"] for a in calls) / steps if steps else None
