"""The long-run measurements of ``tools/`` (the JAX package's), each a
module run as ``python -m tisph_tpu_torch.tools.<name>``:

- ``soak``            a long ``WCSPH.run`` and its end-state metrics;
- ``compare_resort``  the position divergence of R substeps per rebuild
                      against R = 1;
- ``compare_compat``  the divergence of ``compat="reference-exact"`` from
                      ``"reference"``.

They keep the JAX tools' arguments and JSON keys and run on the card
unless ``--cpu`` is given; on a machine with no card they raise rather
than fall back to the CPU.
"""

from __future__ import annotations

import torch


def tool_device(cpu: bool) -> torch.device:
    """The CPU if ``cpu``, else the card, which must be there."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return torch.device("cuda")

