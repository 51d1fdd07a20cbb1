"""CSR cell bounds: the CUDA kernel ``csrc/bounds.cu`` and its dispatch.

Replaces ``tisph_tpu/ops/pallas/bounds.py::_bounds_kernel`` (launched by
``csr_bounds_sorted`` there, called from ``grid.csr_bounds_fast``).  The
plain version is ``ops.grid.csr_bounds`` (``torch.searchsorted``), with
the same signature: a CPU tensor goes there, a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from tisph_tpu_torch.ops.cuda import build
from tisph_tpu_torch.ops.grid import GridSpec, csr_bounds


def csr_bounds_sorted(sorted_ids: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """bounds[c] = first sorted index with id >= c, for c in [0,
    num_cells]: (num_cells + 1,) int32.  ``sorted_ids``: (N,) int32,
    ascending, inactive tail = ``spec.num_cells``."""
    if sorted_ids.device.type == "cpu":
        return csr_bounds(sorted_ids, spec)
    if sorted_ids.device.type != "cuda":
        raise ValueError(f"csr_bounds_sorted: unsupported device {sorted_ids.device}")
    if sorted_ids.dtype != torch.int32 or sorted_ids.dim() != 1:
        raise ValueError(f"csr_bounds_sorted: need (N,) int32 ids, got "
                         f"{tuple(sorted_ids.shape)} {sorted_ids.dtype}")
    if not sorted_ids.is_contiguous():
        raise ValueError("csr_bounds_sorted: ids must be contiguous")
    n = sorted_ids.shape[0]
    if n >= 2**31 - 1 or spec.num_cells >= 2**31 - 1:
        raise ValueError("csr_bounds_sorted: sizes must fit in int32")
    out = torch.empty((spec.num_cells + 1,), dtype=torch.int32, device=sorted_ids.device)
    with torch.cuda.device(sorted_ids.device):
        err = build.load().tisph_csr_bounds(
            sorted_ids.data_ptr(), n, spec.num_cells, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "csr_bounds_sorted")
    csr_bounds_sorted.launches += 1
    return out


csr_bounds_sorted.launches = 0
