"""Simulation state: a dataclass of tensors on one device.

The same fields, dtypes and padding convention as
``tisph_tpu.models.state.SimState``: every tensor has leading axis
``capacity``; slots past the live particles carry ``material ==
MATERIAL_INVALID`` and are sorted into the sentinel cell, so they never
appear as neighbours.  ``num_active`` is a plain int here: only emitters
change it, and the host decides when they fire (``geometry.emitter``).

:func:`state_to_host` and :func:`state_from_host` use the same dict of
numpy arrays as ``tisph_tpu.models.state.state_to_host``, so a state
carries over between the two packages in either direction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tisph_tpu_torch.utils.profiling import span

# Material codes (the reference's).
MATERIAL_BOUNDARY = 0
MATERIAL_FLUID = 1
MATERIAL_INVALID = -1

_HOST_FIELDS = ("x", "v", "density", "pressure", "mass", "volume",
                "material", "color", "object_id")


@dataclasses.dataclass(frozen=True)
class SimState:
    """Particle SoA state; solvers return new states instead of mutating."""

    x: torch.Tensor          # (N, dim) f32 positions
    v: torch.Tensor          # (N, dim) f32 velocities
    density: torch.Tensor    # (N,) f32
    pressure: torch.Tensor   # (N,) f32
    mass: torch.Tensor       # (N,) f32, volume * density
    volume: torch.Tensor     # (N,) f32, V0 for fluid; Akinci 1/sum(W) for boundary
    material: torch.Tensor   # (N,) i32 MATERIAL_* codes
    color: torch.Tensor      # (N, 3) f32
    object_id: torch.Tensor  # (N,) i32
    num_active: int

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def active_mask(self) -> torch.Tensor:
        return self.material != MATERIAL_INVALID

    @property
    def fluid_mask(self) -> torch.Tensor:
        return self.material == MATERIAL_FLUID

    @property
    def boundary_mask(self) -> torch.Tensor:
        return self.material == MATERIAL_BOUNDARY


def pad_capacity(n: int, multiple: int = 8) -> int:
    """Round a capacity up to ``multiple``."""
    return int(-(-n // multiple) * multiple)


def make_state(
    positions: np.ndarray,
    velocities: np.ndarray,
    densities: np.ndarray,
    pressures: np.ndarray,
    materials: np.ndarray,
    colors: np.ndarray,
    object_ids: np.ndarray,
    volume0: float,
    device: str | torch.device,
    capacity: int,
) -> SimState:
    """Assemble a SimState from host arrays, padded to ``capacity``, with
    mass = volume * density (computed in f32 on the host, as ``tisph_tpu``
    does)."""
    n = positions.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < particle count {n}")

    def pad(arr: np.ndarray, fill: float) -> np.ndarray:
        out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:n] = arr
        return out

    density = pad(densities.astype(np.float32), 0.0)
    volume = np.full((capacity,), volume0, dtype=np.float32)
    host = {
        "x": pad(positions.astype(np.float32), 0.0),
        "v": pad(velocities.astype(np.float32), 0.0),
        "density": density,
        "pressure": pad(pressures.astype(np.float32), 0.0),
        "mass": volume * density,
        "volume": volume,
        "material": pad(materials.astype(np.int32), MATERIAL_INVALID),
        "color": pad(colors.astype(np.float32), 0.0),
        "object_id": pad(object_ids.astype(np.int32), -1),
    }
    return SimState(**{k: torch.tensor(a, device=device) for k, a in host.items()},
                    num_active=n)


def pad_state_capacity(state: SimState, capacity: int) -> SimState:
    """Grow the capacity with inactive slots (integer fields -1, floats 0)."""
    if capacity == state.capacity:
        return state
    if capacity < state.capacity:
        raise ValueError("capacity can only grow")
    extra = capacity - state.capacity

    def grow(a: torch.Tensor) -> torch.Tensor:
        fill = MATERIAL_INVALID if not a.is_floating_point() else 0
        tail = torch.full((extra,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
        return torch.cat([a, tail])

    return dataclasses.replace(
        state, **{k: grow(getattr(state, k)) for k in _HOST_FIELDS}
    )


def state_to_host(state: SimState) -> dict[str, np.ndarray]:
    """Host snapshot of the live particles: each field sliced to
    ``num_active`` rows, plus ``num_active``.

    Each field is ``[:n].to("cpu", non_blocking=True)``: on a CUDA device
    PyTorch copies it asynchronously, on the current stream behind the
    queued work, into a fresh pinned tensor from its caching host
    allocator, and the stream is waited on once, after the nine copies.
    No later call writes the returned arrays; a tensor goes back to the
    allocator, for a later dump, only after the caller drops its array.
    On the CPU each field is its own ``[:n]``, as ``.cpu()`` gives.

    One ``state.to_host`` span (``utils.profiling``) with the ``bytes``
    and ``fields`` copied (and ``pinned=1`` on a CUDA device), around
    ``state.to_host.copy``; while recording on a CUDA device a
    ``state.to_host.wait`` first waits for the queued work, so the
    copies' span holds only the copies and their wait."""
    n = state.num_active
    cuda = state.x.is_cuda
    with span("state.to_host") as sp:
        if sp is not None and cuda:
            with span("state.to_host.wait"):
                torch.cuda.current_stream(state.x.device).synchronize()
        with span("state.to_host.copy"):
            host = {k: getattr(state, k)[:n].to("cpu", non_blocking=True) for k in _HOST_FIELDS}
            if cuda:
                torch.cuda.current_stream(state.x.device).synchronize()
            host = {k: t.numpy() for k, t in host.items()}
        if sp is not None:
            sp.attrs.update(bytes=sum(a.nbytes for a in host.values()), fields=len(host))
            if cuda:
                sp.attrs["pinned"] = 1
    return host | {"num_active": np.asarray(n)}


def state_from_host(d: dict[str, np.ndarray], device: str | torch.device) -> SimState:
    """Build a SimState on ``device`` from a :func:`state_to_host` dict of
    either package.  Capacity equals ``num_active``: the dict holds live
    particles only (:func:`pad_state_capacity` adds inactive slots)."""
    n = int(d["num_active"])
    fields = {}
    for k in _HOST_FIELDS:
        a = np.asarray(d[k])
        if a.shape[0] != n:
            raise ValueError(f"field {k!r} has {a.shape[0]} rows, num_active is {n}")
        want = np.int32 if k in ("material", "object_id") else np.float32
        if a.dtype != want:
            raise ValueError(f"field {k!r} has dtype {a.dtype}, expected {np.dtype(want)}")
        fields[k] = torch.tensor(a, device=device)  # a copy: never aliases d
    return SimState(**fields, num_active=n)
