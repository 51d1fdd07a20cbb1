"""Multi-device WCSPH: the 1-D slab decomposition (``domain``), the
counterpart of ``tisph_tpu.parallel``'s ``ShardedWCSPH`` and
``make_mesh``."""

from tisph_tpu_torch.parallel.domain import Mesh, ShardedWCSPH, make_mesh

__all__ = ["Mesh", "ShardedWCSPH", "make_mesh"]
