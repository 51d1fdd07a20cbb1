"""Sharded WCSPH over a 1-D mesh of devices: spatial slabs, one controller.

The counterpart of ``tisph_tpu.parallel.domain`` (``ShardedWCSPH``,
``make_mesh``).  The globally cell-sorted particle array is cut into
equal chunks of rows, one per shard; flat cell ids are x-major, so the
chunks are spatial slabs.  As JAX's ``shard_map`` program, one Python
controller drives every shard: a :class:`Mesh` is an explicit tuple of
``torch.device``s, shard s lives on ``mesh.devices[s]``, and the state is
a list of per-shard :class:`SimState` s.  A halo or edge exchange is a
slice of the neighbour's tensors and a ``.to(device, non_blocking=True)``;
JAX's ``pmax`` and ``psum`` are per-shard partials combined on shard 0's
device.  Several shards may share one device (``make_mesh(devices=
["cuda:0"] * 4)``, or ``["cpu"] * 4`` for tests): that runs the exchange
on one card and measures its cost, not any scaling.

One R-group (``SolverBase._groups``, as the single-device solver):

- ``_build``, once per group: the resort, which is also the migration
  between shards.  ``resort="exchange"`` (``_exchange_resort``): each
  shard stably sorts [left neighbour's last E rows, own rows, right
  neighbour's first E rows] by cell id and keeps its own count of rows
  from the left edge on; a seam guard, one device scalar for all shards,
  proves the result is the global stable sort, else the global sort's
  result is taken and the trip counts in ``occ_resort``.  On the graph
  path both run and every field is selected on the device (``tisph_tpu``'s
  ``lax.cond``, ``domain.py:492-502``, with both branches run); the eager
  loop reads the guard on the host (its one host wait per group) and runs
  the global sort only when it trips.  ``resort="global"``: the whole
  array sorted on shard 0's device and cut (``_global_resort``).  Then per
  shard the ids of its
  halo-extended window (own rows plus ``halo`` rows each side, cut at the
  array's ends) and their CSR bounds (kernel B), the window's sort-time
  material and the group's masses;
- ``_apply``, every substep: per shard, over its window, the phases of
  ``WCSPH._apply`` through its row-local helpers (``per_step`` bvol,
  density, ``eos_packs``, force or force_react, ``advance``), each sweep
  a launch of kernel A over the shard's rows of the window
  (``rows=(off, rows)``) after a value-only exchange of the packs it reads
  (pos; then vel and aux).  ``MeshSolver._apply`` is shared with the
  rectangle solver (``domain2d``), whose exchange and rows differ.

``layout="linear"`` (R = 1, ``tisph_tpu``'s ``_step_fn_windowed``,
``domain.py:891-1024``) runs the density and force sweeps as kernel C
over the shard's rows of its window: a shard's rows start at a multiple
of 128 of the global array, so C's blocks are the single-device ones.

The halo depth is fixed between rebuilds; each build checks that the
window covers the sort-time stencil of every live row it holds
(``occ_halo``), and :meth:`run` deepens the halo (and the resort's edge)
when that trips, as ``tisph_tpu``'s ``run`` does.  With a halo of more
than two shards the window is the whole array (JAX's all-gather path).

When every shard lives on one CUDA device, each R-group (of ``rollout``,
``rollout_coupled``, ``rollout_emit``, ``step`` and ``run``) is one CUDA
graph replay (``models.graphs``): ``occ_halo`` and ``occ_resort`` are
device scalars updated in place, and what ``run``'s steering changes (the
halo, its path, the edge, the resort) is in the graph's key.  A mesh over
several devices keeps the eager loop (``eager_loop``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from tisph_tpu_torch.config import SceneConfig, SolverParams
from tisph_tpu_torch.geometry.emitter import EMIT_FIELDS, EmitterState, activate_rows
from tisph_tpu_torch.models.rigid import (
    RigidState,
    body_sums,
    make_rigid_state,
    move_body_rows,
    step_bodies,
)
from tisph_tpu_torch.models.solver_base import SolverBase
from tisph_tpu_torch.models.state import SimState, pad_state_capacity
from tisph_tpu_torch.models.wcsph import advance, eos_packs, group_masses, per_step_volumes
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.ops.consts import device_constant
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.ops.neighbors import pack4

# rows: shard sizes, halo and edge depths are multiples of it (tisph_tpu's
# block size), which also keeps every shard's slice of an int32 or f32
# array 16-byte aligned for the kernels
BLOCK = 128


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard s runs on ``devices[s]``; ``shape`` is the mesh's axes, (n,)
    for the slab solver, (sx, sy) or (sx, sy, sz) for the rectangle one
    (shards in row-major order)."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...] | None = None  # None: (len(devices),)

    def __post_init__(self):
        shape = (len(self.devices),) if self.shape is None else tuple(int(v) for v in self.shape)
        if math.prod(shape) != len(self.devices) or min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} does not hold {len(self.devices)} devices")
        object.__setattr__(self, "shape", shape)

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def mesh_devices(n_devices: int | None, devices, name: str) -> tuple[torch.device, ...]:
    """``devices`` (one per shard, repeats allowed), or the first
    ``n_devices`` CUDA devices (all of them for None); raises when there
    are fewer CUDA devices, never falling back to the CPU."""
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if n_devices is not None and len(devs) != n_devices:
            raise ValueError(f"{name}: {len(devs)} devices given for {n_devices} shards")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else int(n_devices)
        if n < 1 or have < n:
            raise RuntimeError(f"{name}: need {max(n, 1)} CUDA devices, have {have}; "
                               "pass devices=[...] to place shards explicitly")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError(f"{name}: no devices")
    return devs


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over ``devices`` (one per shard, repeats allowed), or
    over the first ``n_devices`` CUDA devices (all of them for None).
    Raises when there are fewer CUDA devices: unlike ``tisph_tpu``'s
    ``make_mesh`` it never falls back to the CPU; a caller that wants
    several shards on one device, or on the CPU, says so in ``devices``."""
    return Mesh(mesh_devices(n_devices, devices, "make_mesh"))


class ShardCache(NamedTuple):
    """One shard's part of an R-group's structure."""

    ids: torch.Tensor       # (W,) i32 sort-time ids of the shard's window
    bounds: torch.Tensor    # (num_cells + 1,) i32 CSR bounds of ``ids``
    material: torch.Tensor  # (W,) i32 sort-time material of the window
    rows: tuple[int, int]   # (offset of the shard's rows in the window, count)
    fluid: torch.Tensor     # (rows,) bool, sort-time, the shard's rows
    boundary: torch.Tensor  # (rows,) bool
    effm: torch.Tensor      # (rows,) f32 fl * m + bd * rho0 * V
    flm: torch.Tensor       # (rows,) f32 fl * m


def _cat_to(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


class MeshSolver(SolverBase):
    """What the slab and the rectangle solver share: the state is a list of
    per-shard SimStates, shard s on ``mesh.devices[s]`` with
    ``shard_rows`` rows; the substep (``_apply``) and the coupled substep
    run every shard over its extended arrays, which ``_halo`` makes and
    whose rows each cache's ``rows`` names.  On one device a group
    replays as one CUDA graph; a mesh over several devices sets
    ``eager_loop``."""

    eager_loop = None

    def __init__(self, scene: SceneConfig, mesh: Mesh, compat: str, resort_every: int,
                 fast_math: bool, layout: str, boundary_mode: str | None,
                 params: SolverParams | None, *, graphs: bool | None = None):
        if len(set(mesh.devices)) > 1:
            self.eager_loop = ("its shards span several devices, and a group is one graph on "
                               "one device; a graph per device is later work")
        dynamic = any(rb.is_dynamic for rb in scene.rigid_bodies)
        if boundary_mode is None:
            boundary_mode = "per_step" if dynamic else "static"
        if dynamic and layout != "seg":
            # the linear kernel has no force_react mode (as WCSPHRigid)
            raise ValueError(f"a scene with a dynamic body runs layout='seg', not {layout!r}")
        super().__init__(scene, compat=compat, device=mesh.devices[0], resort_every=resort_every,
                         fast_math=fast_math, layout=layout, boundary_mode=boundary_mode,
                         params=params, graphs=graphs)
        self.mesh = mesh
        self.n_shards = mesh.size
        self.shard_rows: int | None = None

    def _check_device(self, shards) -> None:
        if not isinstance(shards, (list, tuple)) or len(shards) != self.n_shards:
            raise ValueError(f"{type(self).__name__}: the state must be a list of "
                             f"{self.n_shards} shards (bind a global state first)")
        for s, (st, dev) in enumerate(zip(shards, self.mesh.devices)):
            if st.device != dev or st.capacity != self.shard_rows:
                raise ValueError(f"shard {s}: {st.capacity} rows on {st.device}, want "
                                 f"{self.shard_rows} on {dev}")

    def _halo(self, parts: list[torch.Tensor], caches) -> list[torch.Tensor]:
        """Each shard's extended array of the per-shard tensors ``parts``
        (the value-only exchange of one pack), on its device."""
        raise NotImplementedError

    def _apply(self, shards, caches, with_reactions: bool = False):
        """One substep of every shard, the phases of ``WCSPH._apply`` over
        each shard's extended arrays, its rows ``caches[s].rows``; with
        ``with_reactions`` also the (rows, dim) reactions of each shard
        (``force_react``)."""
        spec, params, fm = self.spec, self.params, self.fast_math
        n = range(self.n_shards)
        shards = list(shards)
        effm = [c.effm for c in caches]
        if self.boundary_mode == "per_step":
            pos_b = self._halo([pack4(st.x, c.boundary.to(torch.float32))
                                for st, c in zip(shards, caches)], caches)
            for s in n:
                c, st = caches[s], shards[s]
                delta = cuda_sweeps.bvol_sweep(pos_b[s], c.ids, c.bounds, c.material, spec,
                                               params, fm, rows=c.rows)
                volume, effm[s] = per_step_volumes(delta, c.boundary, st.volume, c.flm,
                                                   params.density0)
                shards[s] = dataclasses.replace(st, volume=volume)

        linear = self.layout == "linear"
        density = cuda_sweeps.density_sweep_linear if linear else cuda_sweeps.density_sweep
        pos_e = self._halo([pack4(st.x, effm[s]) for s, st in enumerate(shards)], caches)
        vel, aux, eos = [], [], []
        for s in n:
            c, st = caches[s], shards[s]
            rho = density(pos_e[s], c.ids, c.bounds, c.material, spec, params, fm, rows=c.rows)
            rho, pressure, v, a = eos_packs(rho, st, c.fluid, c.flm, params)
            vel.append(v)
            aux.append(a)
            eos.append((rho, pressure))

        if with_reactions:
            sweep = cuda_sweeps.force_react_sweep
        else:
            sweep = cuda_sweeps.force_sweep_linear if linear else cuda_sweeps.force_sweep
        vel_e, aux_e = self._halo(vel, caches), self._halo(aux, caches)
        reactions = []
        for s in n:
            c, st = caches[s], shards[s]
            dv = sweep(pos_e[s], vel_e[s], aux_e[s], c.ids, c.bounds, c.material, spec, params,
                       fm, rows=c.rows)
            shards[s] = advance(st, *eos[s], dv, params)
            if with_reactions:
                reactions.append(torch.where(c.boundary[:, None], dv, 0.0))
        return (shards, reactions) if with_reactions else shards

    # -- dynamic rigid bodies ---------------------------------------------
    def init_rigid(self, shards: list[SimState]) -> RigidState:
        """Bodies at rest, on shard 0's device."""
        return make_rigid_state(self.gather_state(shards), self.scene)

    def _coupled_substep(self, carry: tuple, caches) -> tuple:
        """``WCSPHRigid._coupled_substep`` over the shards: each body's sums
        are the shards' partial sums added on shard 0's device."""
        shards, rigid = carry
        shards, reactions = self._apply(shards, caches, with_reactions=True)
        dev0, params = self.mesh.devices[0], self.params
        local = [_rigid_to(rigid, dev) for dev in self.mesh.devices]
        sums = []
        for k in range(rigid.num_bodies):
            parts = [[t.to(dev0, non_blocking=True) for t in
                      body_sums(st.x, st.mass, st.object_id, c.boundary, local[s],
                                reactions[s], k, params)]
                     for s, (st, c) in enumerate(zip(shards, caches))]
            force, tau, inertia, pen_lo, pen_hi = parts[0]
            for p in parts[1:]:
                force, tau, inertia = force + p[0], tau + p[1], inertia + p[2]
                pen_lo, pen_hi = torch.maximum(pen_lo, p[3]), torch.maximum(pen_hi, p[4])
            sums.append((force, tau, inertia, pen_lo, pen_hi))
        rigid2, moves = step_bodies(rigid, sums, params, self.spec.dim)
        out = []
        for s, (st, c) in enumerate(zip(shards, caches)):
            dev = self.mesh.devices[s]
            mv = [tuple(t.to(dev, non_blocking=True) for t in m) for m in moves]
            x, v = move_body_rows(st.x, st.v, st.object_id, c.boundary, local[s], mv)
            out.append(dataclasses.replace(st, x=x, v=v))
        return out, rigid2

    def _check_rigid(self, rigid: RigidState) -> None:
        if rigid.com.device != self.mesh.devices[0]:
            raise ValueError(f"rigid state is on {rigid.com.device}, want shard 0's "
                             f"{self.mesh.devices[0]}")

    def step_coupled(self, shards, rigid: RigidState):
        """One coupled substep with a fresh structure."""
        self._check_rigid(rigid)
        return self._groups((shards, rigid), 1, 1, self._coupled_substep)

    def rollout_coupled(self, shards, rigid: RigidState, num_steps: int):
        """``num_steps`` coupled substeps in groups of ``resort_every``."""
        self._check_rigid(rigid)
        return self._groups((shards, rigid), num_steps, self.resort_every,
                            self._coupled_substep)

    def run_coupled(self, shards, rigid: RigidState, num_steps: int, check_every: int = 400,
                    *, verbose: bool = False):
        """``run`` over the ``(shards, rigid)`` carry with
        ``rollout_coupled``: the same chunks and the same steering after
        each (``tisph_tpu``'s ``run_coupled``)."""
        return self._run_chunks((shards, rigid), num_steps, self._roll_coupled, check_every,
                                verbose)

    # -- the chunk loop's view of the shards ---------------------------------
    def _devices(self) -> tuple[torch.device, ...]:
        return self.mesh.devices

    def _num_particles(self, shards) -> int:
        return sum(st.num_active for st in shards)

    def _capacity(self, shards) -> int:
        return self.n_shards * self.shard_rows


class ShardedWCSPH(MeshSolver):
    """WCSPH over a 1-D mesh; the state is a list of per-shard SimStates,
    shard s's ``num_active`` the live rows it holds (the global array keeps
    its live rows first, so shard s holds rows [s R, (s+1) R) of it)."""

    layouts = ("seg", "linear")

    def __init__(
        self,
        scene: SceneConfig,
        mesh: Mesh,
        compat: str = "reference",
        resort_every: int = 1,
        fast_math: bool = True,
        boundary_mode: str | None = None,
        params: SolverParams | None = None,
        halo: int | None = None,
        resort: str = "exchange",
        resort_edge: int | None = None,
        layout: str = "seg",
        graphs: bool | None = None,
    ):
        """``halo``: rows each side of a shard's own in its window (None:
        twice the furthest stencil reach across a shard boundary at bind).
        ``resort``: ``"exchange"`` or ``"global"`` (see the module).
        ``resort_edge``: the exchange's edge depth in rows (None: the
        halo's).  ``boundary_mode`` None: ``"per_step"`` when the scene has
        a dynamic body, else ``"static"``.  ``layout``: ``"seg"`` (kernel
        A) or ``"linear"`` (kernel C, R = 1 only; a dynamic scene refuses
        it).  ``graphs``: each R-group one CUDA graph replay; None is on
        when every shard lives on the same CUDA device, True raises on a
        mesh over several devices.  The rest as ``SolverBase``."""
        if resort not in ("exchange", "global"):
            raise ValueError(f"resort must be 'exchange' or 'global', got {resort!r}")
        if len(mesh.shape) != 1:
            raise ValueError(f"ShardedWCSPH needs a 1-D mesh, got shape {mesh.shape}")
        super().__init__(scene, mesh, compat, resort_every, fast_math, layout, boundary_mode,
                         params, graphs=graphs)
        self.halo = halo
        self.resort = resort
        self.resort_edge = resort_edge
        self.halo_path: str | None = None  # "neighbours" or "all_gather", set at bind
        # () i32 on shard 0's device from the first bind on, updated in place
        # (a graph keeps their addresses): the halo flag, and the seam
        # guard's trips since the last reset
        self.occ_halo: torch.Tensor | None = None
        self.occ_resort: torch.Tensor | None = None

    # -- placement -------------------------------------------------------
    def bind(self, state: SimState) -> list[SimState]:
        """A global state (live rows first) -> the list of shards: static
        boundary volumes computed once, capacity padded with inactive rows
        to a multiple of ``n_shards * BLOCK``, the halo and the edge sized,
        shard s's rows moved to its device."""
        dev0 = self.mesh.devices[0]
        state = _state_to(state, dev0)
        if self.boundary_mode == "static" and bool(state.boundary_mask.any()):
            state = self._precompute_boundary_volumes(state)
        unit = self.n_shards * BLOCK
        state = pad_state_capacity(state, -(-state.capacity // unit) * unit)
        d = self.n_shards
        rps = self.shard_rows = state.capacity // d
        if self.halo is None:
            h = max(BLOCK, -(-int(self._reach(state) * 2.0) // BLOCK) * BLOCK)
            self.halo = min(h, (d - 1) * rps) if d > 1 else BLOCK
        self.halo = max(BLOCK, -(-int(self.halo) // BLOCK) * BLOCK)
        if self.resort == "exchange" and d > 1:
            e = self.resort_edge if self.resort_edge is not None else self.halo
            self.resort_edge = min(max(BLOCK, -(-int(e) // BLOCK) * BLOCK), rps)
        self.halo_path = "neighbours" if self._hops() <= 2 else "all_gather"
        if self.occ_halo is None:
            self.occ_halo = torch.zeros((), dtype=torch.int32, device=dev0)
            self.occ_resort = torch.zeros((), dtype=torch.int32, device=dev0)
        self.occ_halo.zero_()
        self._bound = True
        return self.shard_state(state)

    def _reach(self, state: SimState) -> int:
        """Furthest row, past a shard's own, that a live row's stencil runs
        reach in the globally sorted state (``tisph_tpu``'s
        ``measure_caps_device`` with shard rows)."""
        spec, d, rps = self.spec, self.n_shards, self.shard_rows
        st, ids, _, bounds = cuda_bounds.sort_and_bound(state, spec)
        runs = gridops.stencil_runs(gridops.cell_coords(st.x, spec), bounds, spec)
        valid = (ids < spec.num_cells)[:, None] & (runs[..., 0] < runs[..., 1])
        first = torch.where(valid, runs[..., 0], torch.iinfo(torch.int32).max)
        last = torch.where(valid, runs[..., 1], 0)
        own = torch.arange(d, device=ids.device) * rps
        left = own - first.reshape(d, -1).amin(dim=1)
        right = last.reshape(d, -1).amax(dim=1) - (own + rps)
        return max(int(left.max()), int(right.max()), 0)

    def shard_state(self, state: SimState) -> list[SimState]:
        """A global state's rows (live rows first) cut into the shards, each
        on its device."""
        rps = self.shard_rows
        shards = []
        for s, dev in enumerate(self.mesh.devices):
            fields = {k: getattr(state, k)[s * rps:(s + 1) * rps].to(dev, non_blocking=True)
                      for k in gridops.state_fields(state)}
            shards.append(SimState(**fields, num_active=self._live_rows(state.num_active, s)))
        return shards

    def _live_rows(self, num_active: int, s: int) -> int:
        """Shard s's live rows when the array holds ``num_active`` live rows
        first (as a sort, an emission and bind leave it)."""
        return min(max(num_active - s * self.shard_rows, 0), self.shard_rows)

    def gather_state(self, shards: list[SimState]) -> SimState:
        """The global state on shard 0's device (for metrics, checkpoints
        and export)."""
        dev0 = self.mesh.devices[0]
        fields = {k: _cat_to([getattr(st, k) for st in shards], dev0)
                  for k in gridops.state_fields(shards[0])}
        return SimState(**fields, num_active=sum(st.num_active for st in shards))

    def _hops(self) -> int:
        return max(1, -(-self.halo // self.shard_rows))

    def _window(self, s: int, depth: int | None = None) -> tuple[int, int]:
        """Global rows [g0, g1) of shard s's window: its own rows and
        ``depth`` more each side, cut at the array's ends.  ``depth`` None
        is the halo, and the whole array when the halo spans more than two
        shards."""
        rps, cap = self.shard_rows, self.shard_rows * self.n_shards
        if depth is None:
            if self._hops() > 2:
                return 0, cap
            depth = self.halo
        return max(0, s * rps - depth), min(cap, (s + 1) * rps + depth)

    def _extend(self, parts: list[torch.Tensor], s: int,
                depth: int | None = None) -> torch.Tensor:
        """Shard s's window (``_window``) of the per-shard tensors ``parts``:
        the halo exchange, or with ``depth`` the resort's edges; a new
        tensor on shard s's device."""
        g0, g1 = self._window(s, depth)
        rps = self.shard_rows
        pieces = [parts[t][max(g0, t * rps) - t * rps:min(g1, (t + 1) * rps) - t * rps]
                  for t in range(g0 // rps, -(-g1 // rps))]
        return _cat_to(pieces, self.mesh.devices[s])

    # -- the resort ------------------------------------------------------
    def _cell_ids(self, st: SimState) -> torch.Tensor:
        spec = self.spec
        return gridops.flat_cell_ids(gridops.cell_coords(st.x, spec), st.material, spec)

    def _resort(self, shards: list[SimState]) -> tuple[list[SimState], list[torch.Tensor]]:
        """The shards in global stable cell order and their sorted ids."""
        if self.resort != "exchange" or self.n_shards == 1:
            return self._global_resort(shards)
        order, bad = self._exchange_order(shards)
        self.occ_resort.add_(bad.to(torch.int32))
        if not self.graphs:
            if bool(bad):  # the host wait of an eager group
                return self._global_resort(shards)
            return self._exchange_gather(shards, order)
        # tisph_tpu's lax.cond(bad > 0, global sort, exchange) with both
        # branches run: the exchange's gather reads only each shard's own
        # window, so a tripped guard leaves rows that are thrown away here
        x_st, x_ids = self._exchange_gather(shards, order)
        g_st, g_ids = self._global_resort(shards)
        out, ids = [], []
        for x, g, xi, gi, dev in zip(x_st, g_st, x_ids, g_ids, self.mesh.devices):
            take = bad.to(dev, non_blocking=True)
            out.append(dataclasses.replace(x, **{k: torch.where(take, getattr(g, k), getattr(x, k))
                                                 for k in gridops.state_fields(x)}))
            ids.append(torch.where(take, gi, xi))
        return out, ids

    def _global_resort(self, shards):
        """The whole array sorted on shard 0's device (the rebuild kernel
        after ``torch.sort``) and cut into the shards again."""
        st, ids, _, _ = cuda_bounds.sort_and_bound(self.gather_state(shards), self.spec)
        rps = self.shard_rows
        ids_l = [ids[s * rps:(s + 1) * rps].to(dev, non_blocking=True)
                 for s, dev in enumerate(self.mesh.devices)]
        return self.shard_state(st), ids_l

    def _exchange_order(self, shards):
        """``tisph_tpu``'s edge-exchange resort (``domain.py:398-510``): per
        shard its kept (sorted ids, permutation of its edged window), and
        the () bool seam guard on shard 0's device, True when it trips.

        The array is sorted from the last rebuild, so a row's global rank
        moves by few rows per group.  Shard s stably sorts the cell ids of
        [left neighbour's last E rows, own rows, right neighbour's first E
        rows] (an end shard has no edge on the open side), which are in
        previous global order, and keeps ``rows`` of them from the left
        edge on.  When no rank moved by more than E that is exactly its
        part of the global stable sort.  Guard: every seam between shards
        strictly increasing in (cell id, previous global index) makes the
        concatenation a permutation of the rows in sorted order, which is
        then the stable sort; a lost or duplicated row breaks some seam."""
        rps, E = self.shard_rows, self.resort_edge
        ids = [self._cell_ids(st) for st in shards]
        order, ends = [], []
        for s in range(self.n_shards):
            lo = s * rps - self._window(s, E)[0]  # the left edge's rows
            sorted_ids, perm = torch.sort(self._extend(ids, s, E), stable=True)
            k_ids, k_perm = sorted_ids[lo:lo + rps], perm[lo:lo + rps]
            order.append((k_ids, k_perm))
            # (id, previous global index) of the first and last kept rows; no
            # index list, which would be a copy from the host
            first_last = torch.stack([k_ids[0].to(torch.int64), k_ids[-1].to(torch.int64),
                                      k_perm[0] + (s * rps - lo), k_perm[-1] + (s * rps - lo)])
            ends.append(first_last.view(2, 2))
        ends = _cat_to([e[None] for e in ends], self.mesh.devices[0])  # (d, 2 [id, src], 2)
        prev_id, prev_src = ends[:-1, 0, 1], ends[:-1, 1, 1]
        first_id, first_src = ends[1:, 0, 0], ends[1:, 1, 0]
        ok = (prev_id < first_id) | ((prev_id == first_id) & (prev_src < first_src))
        return order, ~ok.all()

    def _exchange_gather(self, shards, order):
        """Each shard's rows in the order ``_exchange_order`` kept, gathered
        from its edged window by the rebuild kernel, and its sorted ids."""
        E = self.resort_edge
        total = sum(st.num_active for st in shards)
        out = []
        for s, (k_ids, k_perm) in enumerate(order):
            edged = SimState(**{k: self._extend([getattr(st, k) for st in shards], s, E)
                                for k in gridops.state_fields(shards[s])}, num_active=0)
            st, _ = cuda_bounds.gather_and_bound(edged, k_ids, k_perm, self.spec)
            out.append(dataclasses.replace(st, num_active=self._live_rows(total, s)))
        return out, [o[0] for o in order]

    # -- one R-group -----------------------------------------------------
    def _build(self, shards):
        """Resort, then each shard's window: ids, bounds (kernel B),
        sort-time material, the group's masses; and the halo check."""
        shards, ids_l = self._resort(shards)
        params, spec = self.params, self.spec
        mat_l = [st.material for st in shards]
        caches = []
        for s, st in enumerate(shards):
            ids_e = self._extend(ids_l, s)
            fluid, bd = st.fluid_mask, st.boundary_mask
            flm, effm = group_masses(st, fluid, bd, params.density0)
            g0 = self._window(s)[0]
            caches.append(ShardCache(ids_e, cuda_bounds.csr_bounds_sorted(ids_e, spec),
                                     self._extend(mat_l, s), (s * self.shard_rows - g0,
                                                              st.capacity),
                                     fluid, bd, effm, flm))
            self._check_cover(s, ids_l[s], ids_e)
        return shards, caches

    def _check_cover(self, s: int, ids_own: torch.Tensor, ids_e: torch.Tensor) -> None:
        """occ_halo |= 1 when a live row of shard s has a sort-time stencil
        cell outside the ids its window spans (a window end inside the
        array whose id is not past every such cell): the sweeps would miss
        candidates beyond it.  A device flag; nothing is read here."""
        spec, dev = self.spec, ids_own.device
        g0, g1 = self._window(s)
        # a row's lowest and highest stencil cells: each axis's neighbour
        # coordinate clamped into the grid (the corners of its 3^dim block)
        coords = gridops.coords_from_ids(ids_own, spec)
        top = device_constant([r - 1 for r in spec.res], torch.int32, dev)
        strides = device_constant(spec.strides, torch.int32, dev)
        lo = (torch.clamp(coords - 1, min=0) * strides).sum(-1)
        hi = (torch.minimum(coords + 1, top) * strides).sum(-1)
        live = ids_own < spec.num_cells
        lo_min = torch.where(live, lo, spec.num_cells).min()
        hi_max = torch.where(live, hi, -1).max()
        short = torch.zeros((), dtype=torch.bool, device=dev)
        if g0 > 0:
            short = short | ((lo_min < spec.num_cells) & (ids_e[0] >= lo_min))
        if g1 < self.shard_rows * self.n_shards:
            short = short | ((hi_max >= 0) & (ids_e[-1] <= hi_max))
        self.occ_halo.copy_(torch.maximum(
            self.occ_halo, short.to(torch.int32).to(self.mesh.devices[0], non_blocking=True)))

    def _halo(self, parts, caches):
        return [self._extend(parts, s) for s in range(self.n_shards)]

    # -- emitters: the global tail pool -----------------------------------
    def _with_live(self, shards, num_active: int) -> list[SimState]:
        return [dataclasses.replace(st, num_active=self._live_rows(num_active, s))
                for s, st in enumerate(shards)]

    def _emit_batch(self, shards, es: EmitterState, e: int, start) -> list[SimState]:
        """A batch in global rows [start, start + b), the first inactive
        rows of the array, which may straddle a shard boundary: every shard
        writes the rows of it that it holds by a fixed-shape scatter that
        drops the rest (``activate_rows``), so the eager loop (``start`` a
        host int) and a replay (a device scalar) write the same rows."""
        rps, b = self.shard_rows, es.batch_size
        out = []
        for s, (st, dev) in enumerate(zip(shards, self.mesh.devices)):
            off = start - s * rps
            if isinstance(off, torch.Tensor):
                off = off.to(dev, non_blocking=True)
            at = torch.arange(b, dtype=torch.int64, device=dev) + off
            at = torch.where((at >= 0) & (at < rps), at, rps)
            fields = activate_rows({f: getattr(st, f) for f in EMIT_FIELDS}, at,
                                   es.seeds_x.to(dev), es.velocity.to(dev), es.color.to(dev),
                                   es.density.to(dev), self.scene.particle_volume0)
            out.append(dataclasses.replace(st, **fields))
        return out

    # -- adaptive run and metrics ------------------------------------------
    def regrow_halo(self, new_halo: int | None = None) -> None:
        """Deepen the halo (default: double), up to the whole array."""
        h = int(new_halo if new_halo is not None else self.halo * 2)
        h = max(BLOCK, -(-h // BLOCK) * BLOCK)
        if self.n_shards > 1:
            h = min(h, (self.n_shards - 1) * self.shard_rows)
        self.halo = h
        self.halo_path = "neighbours" if self._hops() <= 2 else "all_gather"

    def regrow_resort_edge(self, new_edge: int | None = None) -> None:
        """Deepen the exchange resort's edge (default: double), up to a
        shard's rows."""
        if self.resort != "exchange" or self.n_shards <= 1:
            return
        e = int(new_edge if new_edge is not None else (self.resort_edge or BLOCK) * 2)
        self.resort_edge = min(max(BLOCK, -(-e // BLOCK) * BLOCK), self.shard_rows)

    def _capture_key(self) -> tuple:
        """Beyond ``SolverBase``'s: the shard rows, and the halo, its path,
        the edge and the resort, which ``run``'s steering changes."""
        return super()._capture_key() + (self.shard_rows, self.halo, self.halo_path,
                                         self.resort_edge, self.resort)

    def _inplace(self) -> tuple[torch.Tensor, ...]:
        return self.occ_halo, self.occ_resort

    def reset_flags(self) -> None:
        """The halo flag and the seam guard's trips back to 0 (in place)."""
        self.occ_halo.zero_()
        self.occ_resort.zero_()

    def _after_chunk(self, carry: tuple, k: int, verbose: bool) -> tuple:
        """``run``'s one read after each chunk: a tripped halo flag deepens
        the halo; seam-guard trips on most of the chunk's rebuilds deepen
        the edge, and at a saturated edge switch the resort to
        ``"global"`` (``tisph_tpu``'s ``run``, ``domain.py:1109``, without
        its window and row-pad caps, which the port has not)."""
        halo, trips = torch.stack([self.occ_halo, self.occ_resort]).tolist()
        if halo:
            old = self.halo
            self.regrow_halo()
            if verbose:
                print(f"[tisph] shard halo reach exceeded depth {old}; deepened to "
                      f"{self.halo}")
        if self.resort == "exchange" and self.n_shards > 1:
            rebuilds = max(1, k // self.resort_every)
            if trips > rebuilds // 2:
                old = self.resort_edge
                self.regrow_resort_edge()
                if self.resort_edge == old:  # saturated: the global sort alone
                    self.resort = "global"
                if verbose:
                    print(f"[tisph] exchange-resort seam guard tripped {trips}/"
                          f"{rebuilds} rebuilds at edge {old}; now edge "
                          f"{self.resort_edge}, resort {self.resort!r}")
        self.reset_flags()
        return carry

    def metrics(self, shards) -> dict[str, float | int]:
        """``SolverBase.metrics`` of the global state, plus the halo flag,
        the halo and edge depths and the seam-guard trips."""
        out = super().metrics(self.gather_state(shards))
        halo, trips = torch.stack([self.occ_halo, self.occ_resort]).tolist()
        return out | {"occ_halo": halo, "halo_depth": int(self.halo),
                      "resort_edge": int(self.resort_edge or 0), "resort_fallbacks": trips}


def _state_to(state: SimState, device: torch.device) -> SimState:
    return dataclasses.replace(state, **{k: getattr(state, k).to(device)
                                         for k in gridops.state_fields(state)})


def _rigid_to(rigid: RigidState, device: torch.device) -> RigidState:
    return RigidState(**{f.name: getattr(rigid, f.name).to(device, non_blocking=True)
                         for f in dataclasses.fields(rigid)})

