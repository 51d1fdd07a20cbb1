"""Utilities: union-find clustering and domain wireframes (numpy only;
copies of ``tisph_tpu.utils.dsu`` and ``tisph_tpu.utils.lines``), state
validation (``debug``) and timers and traces (``profiling``)."""

from tisph_tpu_torch.utils.dsu import DSU, cluster_points
from tisph_tpu_torch.utils.lines import domain_wireframe
