"""Seconds the run spent compiling the port's kernels, the program's
counter ``build.s`` (``tisph_tpu_torch.utils.profiling.counters()``): the
nvcc build on a checkout's first run, 0 when the library was found; none
where the program keeps no such counter."""

import sys


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    return prof.counters().get("build.s") if hasattr(prof, "counters") else None
