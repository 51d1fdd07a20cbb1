"""Solvers: WCSPH (the flagship, the reference's V2 physics) and
WCSPHLegacy (its V1 physics).  Re-exports the names of
``tisph_tpu.models``."""

from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.models.wcsph import WCSPH
from tisph_tpu_torch.models.wcsph_legacy import WCSPHLegacy
