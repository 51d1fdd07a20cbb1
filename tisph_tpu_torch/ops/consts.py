"""Small constant tensors made once per device.

A blocking host-to-device copy (``torch.tensor(data, device="cuda")``)
waits for the stream to drain, so a step that built its constants that
way would hold the host at every call.  The step reads them from here
instead: each (values, dtype, device) is copied once and shared, and no
caller may write to the tensor it gets.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch


@functools.lru_cache(maxsize=None)
def _cached(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        # a host copy cannot be captured, and the tensor would live in the
        # graph's pool: models.graphs warms a group up before its capture
        raise RuntimeError(f"device_constant: first use of {values} inside a CUDA graph "
                           "capture (warm up first)")
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values: Sequence, dtype: torch.dtype,
                    device: str | torch.device) -> torch.Tensor:
    """Read-only tensor of ``values`` on ``device``, copied to it once."""
    return _cached(tuple(values), dtype, torch.device(device))
