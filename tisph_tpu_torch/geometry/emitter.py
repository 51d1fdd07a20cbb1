"""Emitter inflow: fluid particles activated out of the state's inactive
pool, as ``tisph_tpu.geometry.emitter`` does it.

An :class:`EmitterState` holds one lattice-sampled batch of seed positions
(made once, on the solver's device) and its bookkeeping.  Every call of
:func:`maybe_emit` is one solver step of the emitter: when the step is due
(``step % interval == 0``), the pool has room for the whole batch and the
emitter's quota allows it, the batch becomes fluid in rows
``[num_active, num_active + b)``, the first inactive rows of a cell-sorted
state.  A batch that does not fit is not emitted at all.

The bookkeeping (``step``, ``emitted``, ``interval``, ``max_particles``)
is plain host ints, and so is ``SimState.num_active``, which only emission
changes: the host decides whether a batch fires without reading anything
back from the device, and the device does one out-of-place write of the
nine per-particle fields.  The write's start row may be a 0-d device
tensor, so a captured CUDA graph (``models.graphs``) reads it at every
replay where a host int would be frozen into the capture.  The write is
by row index (:func:`activate_rows`), and an index past the end writes
nothing: the sharded solvers write every shard with the same launches
whether the batch lands there or not, and the rectangle, whose room test
runs on the device, writes a refused batch nowhere (:func:`due_step`
counts its cadence alone).
"""

from __future__ import annotations

import dataclasses

import torch

from tisph_tpu_torch.config import Emitter, SceneConfig
from tisph_tpu_torch.geometry.sampler import cube_lattice
from tisph_tpu_torch.models.state import MATERIAL_FLUID, SimState

# object_id stamped on every emitted particle (apart from every fluid-block
# and body id, so diagnostics can tell emitted rows apart)
EMITTER_OBJECT_ID = 10_000

# the nine per-particle fields an activation writes
EMIT_FIELDS = ("x", "v", "density", "pressure", "volume", "mass",
               "material", "color", "object_id")


@dataclasses.dataclass(frozen=True)
class EmitterState:
    """One emitter: the seed batch and its parameters on the device, the
    counters on the host."""

    seeds_x: torch.Tensor   # (B, dim) f32 lattice positions of one batch
    velocity: torch.Tensor  # (dim,) f32
    color: torch.Tensor     # (3,) f32
    density: torch.Tensor   # () f32
    interval: int           # solver steps between batches (>= 1)
    emitted: int            # particles emitted so far
    max_particles: int      # 0 = until the pool is exhausted
    step: int               # solver steps seen

    @property
    def batch_size(self) -> int:
        return self.seeds_x.shape[0]


def make_emitter_state(em: Emitter, scene: SceneConfig,
                       device: str | torch.device = "cuda") -> EmitterState:
    """The seed lattice over ``[em.start, em.end)`` at the particle radius,
    and counters at zero."""
    seeds = cube_lattice(em.start, em.end, scene.particle_radius)
    f32 = dict(dtype=torch.float32, device=device)
    return EmitterState(
        seeds_x=torch.tensor(seeds, **f32),
        velocity=torch.tensor(em.velocity[: scene.dim], **f32),
        color=torch.tensor(em.color, **f32),
        density=torch.tensor(em.density, **f32),
        interval=max(int(em.interval), 1),
        emitted=0,
        max_particles=int(em.max_particles),
        step=0,
    )


def activate_rows(fields: dict[str, torch.Tensor], at: torch.Tensor, seeds: torch.Tensor,
                  velocity: torch.Tensor, color: torch.Tensor, density: torch.Tensor,
                  volume0: float) -> dict[str, torch.Tensor]:
    """The nine EMIT_FIELDS with seed i of one batch in row ``at[i]`` (a
    (b,) int64 tensor on the fields' device), as new tensors: the given
    ones are shared with the caller's state and stay as they are.  An
    ``at`` equal to the fields' row count writes nothing (``tisph_tpu``'s
    scatter ``mode="drop"``): the same launches whichever rows a batch
    lands in, or none.  The rows are written into a copy with one spare
    row past the end, where the dropped seeds land, and which is cut
    off."""
    b, dim = seeds.shape
    like = fields["density"]
    vol = torch.full((b,), volume0, dtype=torch.float32, device=like.device)
    rows = {
        "x": seeds,
        "v": velocity.expand(b, dim),
        "density": density.expand(b),
        "pressure": like.new_zeros(b),
        "volume": vol,
        "mass": vol * density,
        "material": fields["material"].new_full((b,), MATERIAL_FLUID),
        "color": color.expand(b, 3),
        "object_id": fields["object_id"].new_full((b,), EMITTER_OBJECT_ID),
    }
    n = like.shape[0]
    return {k: torch.cat([fields[k], rows[k][:1]]).index_copy_(0, at, rows[k].contiguous())[:n]
            for k in EMIT_FIELDS}


def activate(state: SimState, es: EmitterState, start: int | torch.Tensor,
             volume0: float) -> SimState:
    """``state`` with one batch of ``es`` in rows ``[start, start + b)``
    (``activate_rows``); ``start`` is a host int or a 0-d int64 tensor on
    the state's device, and both write the same rows.  ``num_active`` is
    the caller's to count."""
    at = torch.arange(es.batch_size, dtype=torch.int64, device=state.device) + start
    fields = activate_rows({k: getattr(state, k) for k in EMIT_FIELDS}, at, es.seeds_x,
                           es.velocity, es.color, es.density, volume0)
    return dataclasses.replace(state, **fields)


def count_step(es: EmitterState, room: bool) -> tuple[bool, EmitterState]:
    """(fire, es counted one step): whether this step activates a batch
    (due, ``room`` for the whole batch, under the quota)."""
    b = es.batch_size
    fire = (es.step % es.interval == 0
            and room
            and (es.max_particles <= 0 or es.emitted + b <= es.max_particles))
    return fire, dataclasses.replace(es, emitted=es.emitted + (b if fire else 0),
                                     step=es.step + 1)


def due_step(es: EmitterState) -> tuple[bool, EmitterState]:
    """(due, es counted one step): the cadence alone, for a solver whose
    room and quota test runs on the device (``ShardedWCSPHRect``)."""
    return es.step % es.interval == 0, dataclasses.replace(es, step=es.step + 1)


def maybe_emit(state: SimState, es: EmitterState,
               volume0: float) -> tuple[SimState, EmitterState]:
    """One solver step of the emitter: activate a batch into the pool when
    due, and count the step.  ``state`` must be cell-sorted (its inactive
    rows at the tail), as every solver step leaves it."""
    b = es.batch_size
    fire, es2 = count_step(es, state.num_active + b <= state.capacity)
    if not fire:
        return state, es2
    state = activate(state, es, state.num_active, volume0)
    return dataclasses.replace(state, num_active=state.num_active + b), es2
