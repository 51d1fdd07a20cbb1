"""The median ms a frame's dump waits for the frame's queued device work:
the program's ``state.to_host.wait`` spans (``tisph_tpu_torch.utils.
profiling``, a stream synchronise before the copies, in the traced run's
profiled episode); none where the program recorded no such span."""

import statistics
import sys


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    spans = prof.recorded() if hasattr(prof, "recorded") else []
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == "state.to_host.wait"]
    return statistics.median(ms) if ms else None
