"""Seconds of the graph runner's warm-ups and captures in the run, the
program's counter ``graphs.capture_s`` (``tisph_tpu_torch.utils.
profiling.counters()``): set-up's share spent building CUDA graphs; none
where the program keeps no such counter."""

import sys


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    return prof.counters().get("graphs.capture_s") if hasattr(prof, "counters") else None
