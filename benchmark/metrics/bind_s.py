"""Host seconds of one bind of the solver, to the device's finish: the
program's counters ``bind.s`` over ``bind.calls`` (``tisph_tpu_torch.
utils.profiling.counters()``).  With static boundary rows a bind sorts the
state and sums the Akinci volumes (kernel A's ``bvol`` launch); none where
the program keeps no such counter."""

import sys


def read(rec, variant):
    prof = sys.modules.get("tisph_tpu_torch.utils.profiling")
    counters = prof.counters() if hasattr(prof, "counters") else {}
    calls = counters.get("bind.calls")
    return counters["bind.s"] / calls if calls else None
