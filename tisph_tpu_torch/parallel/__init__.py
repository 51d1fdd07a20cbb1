"""Multi-device WCSPH, the counterpart of ``tisph_tpu.parallel``: the 1-D
slab decomposition (``domain``: ``ShardedWCSPH``, ``make_mesh``) and the
rectangle and box decomposition (``domain2d``: ``ShardedWCSPHRect``, its
alias ``ShardedWCSPH2D``, ``make_mesh2d``, ``make_mesh3d``)."""

from tisph_tpu_torch.parallel.domain import Mesh, ShardedWCSPH, make_mesh
from tisph_tpu_torch.parallel.domain2d import (
    ShardedWCSPH2D,
    ShardedWCSPHRect,
    make_mesh2d,
    make_mesh3d,
)

__all__ = ["Mesh", "ShardedWCSPH", "ShardedWCSPH2D", "ShardedWCSPHRect", "make_mesh",
           "make_mesh2d", "make_mesh3d"]
