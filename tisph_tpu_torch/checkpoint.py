"""Full-state checkpoints as one numpy archive, in the file format of
``tisph_tpu.checkpoint.save_npz`` / ``load_npz``: a file written by either
package loads in the other.

Keys:

- the nine SimState fields over the whole capacity, pool rows included,
  and ``num_active`` as a 0-d int32;
- ``tisph_tpu``'s per-run diagnostic scalars (``occ_window``,
  ``occ_rowpad``, ``occ_halo``, ``occ_resort``, ``occ_shard``), written as
  0-d int32 zeros and ignored on load: the port has no window caps;
- ``rigid__<field>`` for a RigidState (body momentum is not derivable from
  the particles);
- ``emitter<i>__<field>`` for each EmitterState: ``seeds_x``,
  ``velocity``, ``color`` and ``density`` as float32, ``interval``,
  ``emitted``, ``max_particles`` and ``step`` as 0-d int32 (the emission
  cadence is not derivable from the particles either).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tisph_tpu_torch.geometry.emitter import EmitterState
from tisph_tpu_torch.models.rigid import RigidState, rigid_from_host, rigid_to_host
from tisph_tpu_torch.models.state import SimState

_STATE_FIELDS = {"x": np.float32, "v": np.float32, "density": np.float32,
                 "pressure": np.float32, "mass": np.float32, "volume": np.float32,
                 "material": np.int32, "color": np.float32, "object_id": np.int32}
_DIAGNOSTICS = ("occ_window", "occ_rowpad", "occ_halo", "occ_resort", "occ_shard")
_EMITTER_TENSORS = ("seeds_x", "velocity", "color", "density")
_EMITTER_INTS = ("interval", "emitted", "max_particles", "step")


def save_npz(state: SimState, path: str | os.PathLike, rigid: RigidState | None = None,
             emitters: list[EmitterState] | None = None) -> None:
    """Write ``state`` (every row of its capacity) and, optionally, the
    rigid bodies and the emitters to a compressed npz at ``path``."""
    host = {k: getattr(state, k).cpu().numpy() for k in _STATE_FIELDS}
    host["num_active"] = np.asarray(state.num_active, np.int32)
    host.update({k: np.zeros((), np.int32) for k in _DIAGNOSTICS})
    if rigid is not None:
        host.update({f"rigid__{k}": a for k, a in rigid_to_host(rigid).items()})
    for i, es in enumerate(emitters or ()):
        host.update({f"emitter{i}__{k}": getattr(es, k).cpu().numpy() for k in _EMITTER_TENSORS})
        host.update({f"emitter{i}__{k}": np.asarray(getattr(es, k), np.int32)
                     for k in _EMITTER_INTS})
    np.savez_compressed(os.fspath(path), **host)


def _field(z, key: str, dtype) -> np.ndarray:
    a = z[key]
    if a.dtype != dtype:
        raise ValueError(f"checkpoint field {key!r} has dtype {a.dtype}, expected "
                         f"{np.dtype(dtype)}")
    return a


def load_npz(path: str | os.PathLike, with_rigid: bool = False, with_emitters: bool = False,
             device: str | torch.device = "cuda"):
    """The SimState on ``device``, followed by ``RigidState | None`` when
    ``with_rigid`` and by the list of EmitterStates (empty when the file
    holds none) when ``with_emitters``."""
    with np.load(os.fspath(path)) as z:
        fields = {k: torch.tensor(_field(z, k, dt), device=device)
                  for k, dt in _STATE_FIELDS.items()}
        state = SimState(**fields, num_active=int(z["num_active"]))
        rhost = {k[len("rigid__"):]: z[k] for k in z.files if k.startswith("rigid__")}
        ehost: dict[int, dict[str, np.ndarray]] = {}
        for k in z.files:
            if k.startswith("emitter"):
                head, name = k.split("__", 1)
                ehost.setdefault(int(head[len("emitter"):]), {})[name] = z[k]
    out: list = [state]
    if with_rigid:
        out.append(rigid_from_host(rhost, device) if rhost else None)
    if with_emitters:
        ems = []
        for i in sorted(ehost):
            e = ehost[i]
            ems.append(EmitterState(
                **{k: torch.tensor(np.asarray(e[k], np.float32), device=device)
                   for k in _EMITTER_TENSORS},
                **{k: int(e[k]) for k in _EMITTER_INTS}))
        out.append(ems)
    return out[0] if len(out) == 1 else tuple(out)
