"""Rows the port's sweep launches covered, per fluid row and step: the
``sweep_rows`` of the program's ``solver.rollout`` spans (``tisph_tpu_torch.
utils.profiling``, the rise of its sweep wrappers' row tallies in each
call, replays included) over their ``fluid_rows`` times ``steps``, in the
traced run's profiled episode.  A V2 step sweeps every row of the state
twice (density, force), so a pure-fluid state without dead rows reads 2
and boundary rows raise it; none where the program recorded no such span."""

import sys


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    spans = prof.recorded() if hasattr(prof, "recorded") else []
    calls = [s.attrs for s in spans
             if s.name == "solver.rollout" and "sweep_rows" in s.attrs and "fluid_rows" in s.attrs]
    fluid_steps = sum(a["fluid_rows"] * a.get("steps", 0) for a in calls)
    return sum(a["sweep_rows"] for a in calls) / fluid_steps if fluid_steps else None
