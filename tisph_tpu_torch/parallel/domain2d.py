"""Rectangle (x by y) and box (x by y by z) decomposition over a 2- or
3-axis mesh: the counterpart of ``tisph_tpu.parallel.domain2d``
(``ShardedWCSPHRect``, ``ShardedWCSPH2D``, ``make_mesh2d``, ``make_mesh3d``).

The slab solver (``domain``) cuts the globally sorted array into row
chunks, so its shard count is capped by the domain's x-resolution.  Here
shard (i_x, i_y[, i_z]) owns the cells whose coordinate along each cut
axis falls in its interval; each axis is cut at equal-count quantiles of
the bind-time particles, the same cuts across the other axes (a
correctness requirement: misaligned bands would need halo rows from deep
inside diagonal shards, ``domain2d.py:344-397``).  The halo scales with a
rectangle's perimeter or a box's surface, not a whole cross-section.

As the slab solver, one Python controller drives every shard: the state
is a list of per-shard :class:`SimState` s (shard s, row-major over the
mesh's shape, on ``mesh.devices[s]``), each of ``shard_rows`` rows sorted
by cell id with an inactive tail; an exchange is a slice moved with
``.to(device, non_blocking=True)``.  Every buffer has a fixed size (the
per-axis halo and migration caps ``cap_h`` and ``cap_m``), filled by
cumulative count (:func:`_select`), and every overflow is a device flag:
a group reads nothing on the host.

One R-group:

- ``_build``, once per group: migration, one buffered phase per axis, x
  then y then z (a diagonal migrant rides every phase it needs; a migrant
  beyond ``cap_m`` stays where it is for one more rebuild and counts in
  ``occ_resort``); each shard's stable sort of [own, received] by cell id
  and the fixed cut to ``shard_rows`` rows, gathered by the rebuild kernel
  (``gather_and_bound``; rows past the cut count as dropped); the halo,
  one stage per axis, last axis first, each stage selecting from the own
  rows and the halo rows the later axes brought, so corner cells ride
  through; the stable id merge of [own, halos] into the extended ids and
  their bounds (kernel B); the cached row sources of every stage and the
  merge, and the i-row map: where each own row landed in the merge;
- ``_apply`` (``MeshSolver._apply``), every substep: each pack a sweep
  reads is refreshed through the cached sources (``_halo``), and each
  sweep is a launch of kernel A over the shard's own rows by their i-row
  map (``tisph_tpu`` passes the own pack as a separate i side, ``ipack``,
  ``domain2d.py:57-63``; here the own rows in the extended pack are the
  same f32s, so the self pair still gives exactly 0).

The one host read of a call is at its end: each shard's live rows, the
rows the cut dropped (a call raises on any) and, with emitters, the rows
each emitter has emitted.  Emission decides on the device, as
``tisph_tpu``'s ``pmin`` does (``domain2d.py:1011-1030``): the host knows
only which emitters are due.

When every shard lives on one CUDA device, each R-group of ``rollout``,
``rollout_coupled`` and ``rollout_emit`` (and of ``step``, ``run`` and the
coupled ones) is one CUDA graph replay (``models.graphs``): the shards'
tensors are the graph's static carry, the live-row counts, the flags and
the emitted rows are static tensors the group updates in place, and
everything a capture bakes in that the steering of ``run`` changes (the
rows of a shard, the halo and migration caps, the cuts) is in the graph's
key, so a rebalance or a regrow captures anew.  A mesh over several
devices keeps the eager loop (``eager_loop``).

Two faults of ``tisph_tpu``'s rectangle solver are not copied: its
substeps call ``tait_pressure`` directly and skip the density mode of
single-device ``WCSPH`` (``domain2d.py:947``, ``:1085``), where this one
runs ``eos_packs``; and its ``make_mesh2d`` falls back to the CPU, where
this one raises without enough CUDA devices.  Rows dropped by the fixed
cut, which the reference detects only in ``run``, raise here in every
rollout.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np
import torch

from tisph_tpu_torch.config import SceneConfig, SolverParams
from tisph_tpu_torch.geometry.emitter import EMIT_FIELDS, EmitterState, activate_rows
from tisph_tpu_torch.models.rigid import RigidState
from tisph_tpu_torch.models.state import MATERIAL_INVALID, SimState, pad_state_capacity
from tisph_tpu_torch.models.wcsph import group_masses
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.ops.consts import device_constant
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.parallel.domain import (
    BLOCK,
    Mesh,
    MeshSolver,
    _cat_to,
    _state_to,
    mesh_devices,
)


def make_mesh2d(sx: int, sy: int, devices=None) -> Mesh:
    """An (sx, sy) mesh over ``devices`` (sx * sy of them, row-major,
    repeats allowed) or the first sx * sy CUDA devices; raises without
    enough CUDA devices (``tisph_tpu``'s falls back to the CPU)."""
    return Mesh(mesh_devices(sx * sy, devices, "make_mesh2d"), (sx, sy))


def make_mesh3d(sx: int, sy: int, sz: int, devices=None) -> Mesh:
    """An (sx, sy, sz) mesh, the box decomposition; as :func:`make_mesh2d`."""
    return Mesh(mesh_devices(sx * sy * sz, devices, "make_mesh3d"), (sx, sy, sz))


class RectCache(NamedTuple):
    """One shard's part of an R-group's structure."""

    ids: torch.Tensor       # (W,) i32 sorted ids of the extended array
    bounds: torch.Tensor    # (num_cells + 1,) i32 CSR bounds of ``ids``
    material: torch.Tensor  # (W,) i32 sort-time material of the extended array
    rows: torch.Tensor      # (rows,) i32 i-row map: own row r is extended row rows[r]
    fluid: torch.Tensor     # (rows,) bool, sort-time, the own rows
    boundary: torch.Tensor  # (rows,) bool
    effm: torch.Tensor      # (rows,) f32 fl * m + bd * rho0 * V
    flm: torch.Tensor       # (rows,) f32 fl * m
    stages: tuple           # per axis (up, down): (cap_h,) i64 row sources or None
    perm: torch.Tensor      # (W,) i64 the id merge: extended row k is row perm[k]


def _select(mask: torch.Tensor, cap: int):
    """The first ``cap`` rows of ``mask`` in row order, by cumulative
    count (no host read): ``(idx, valid, taken, over)``, the (cap,) i64
    rows (0 on an empty lane), which lanes hold one, the (n,) rows taken
    and () the masked rows left over."""
    csum = torch.cumsum(mask, 0, dtype=torch.int32)
    k = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    total = csum[-1]
    valid = k <= total
    idx = torch.where(valid, torch.searchsorted(csum, k), 0)
    return idx, valid, mask & (csum <= cap), torch.clamp(total - cap, min=0).to(torch.int64)


class ShardedWCSPHRect(MeshSolver):
    """WCSPH over a 2- or 3-axis mesh (the seg layout only); the state is a
    list of per-shard SimStates.  A shard's ``num_active`` is its live rows
    when a call returns (live rows first in each shard)."""

    layouts = ("seg",)
    emit_on_device = True  # the room test (``_emit_batch``)

    def __init__(
        self,
        scene: SceneConfig,
        mesh: Mesh,
        compat: str = "reference",
        resort_every: int = 1,
        fast_math: bool = True,
        boundary_mode: str | None = None,
        params: SolverParams | None = None,
        balance_slack: float = 1.5,
        buffer_slack: float = 2.0,
        emit_frac: float = 0.9,
        layout: str = "seg",
        graphs: bool | None = None,
    ):
        """``balance_slack``: a shard's rows over the worst bind-time
        shard's particles (and over the mean); ``buffer_slack``: the halo
        and migration caps over the worst pools measured at bind;
        ``emit_frac``: a batch fires only while every owner shard stays
        under this share of its rows, the share ``run`` rebalances at, so
        emission never eats the migrants' headroom.  ``graphs``: each
        R-group one CUDA graph replay; None is on when every shard lives on
        the same CUDA device, True raises on a mesh over several devices
        (a graph per device is later work).  The rest as
        ``ShardedWCSPH``."""
        n_ax = len(mesh.shape)
        if n_ax not in (2, 3):
            raise ValueError(f"need a 2- or 3-axis mesh, got shape {mesh.shape}")
        if scene.dim < 2 or n_ax > scene.dim:
            raise ValueError(f"a {n_ax}-axis mesh cuts the first {n_ax} grid axes; the scene "
                             f"has dim={scene.dim}")
        super().__init__(scene, mesh, compat, resort_every, fast_math, layout, boundary_mode,
                         params, graphs=graphs)
        self.n_ax = n_ax
        self.sizes = mesh.shape
        self.balance_slack = float(balance_slack)
        self.buffer_slack = float(buffer_slack)
        self.emit_frac = float(emit_frac)
        self._index = [tuple(int(i) for i in np.unravel_index(s, self.sizes))
                       for s in range(self.n_shards)]
        # per axis, set by _make_cuts: the cell -> shard table and each
        # shard's cell interval [lo, hi); and the buffer caps in rows
        self._tables: list[tuple[int, ...]] = []
        self._lo: list[list[int]] = []
        self._hi: list[list[int]] = []
        self._cuts_made = 0  # bumps with every new set of cuts
        self.cap_h: list[int] = []
        self.cap_m: list[int] = []
        # on shard 0's device from the first bind on, updated in place (a
        # graph keeps their addresses): each shard's live rows (set by a
        # build, grown by an emission), and the flags [busiest shard's rows,
        # dropped rows, builds with a migration trip, halo overflow]; and
        # from the first emitting call on, each emitter's emitted rows
        self._counts: torch.Tensor | None = None
        self._flags: torch.Tensor | None = None
        self._emitted_rows: torch.Tensor | None = None

    # -- mesh geometry -----------------------------------------------------
    def _neighbour(self, s: int, a: int, d: int) -> int | None:
        """The shard next to s along axis a in direction d, or None."""
        idx = list(self._index[s])
        idx[a] += d
        if not 0 <= idx[a] < self.sizes[a]:
            return None
        return int(np.ravel_multi_index(idx, self.sizes))

    def _shard_of(self, coords: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Each row's shard (row-major) and per-axis shard index, from its
        (N, dim) cell coordinates."""
        per_axis = [device_constant(self._tables[a], torch.int64, coords.device)[
            coords[:, a].long()] for a in range(self.n_ax)]
        lin = per_axis[0]
        for a in range(1, self.n_ax):
            lin = lin * self.sizes[a] + per_axis[a]
        return lin, per_axis

    def _exchange(self, parts, ups, downs, a: int) -> list[torch.Tensor]:
        """Each shard's ``parts`` with what its neighbours along axis a sent
        appended: the buffer bound up from the lower one, then the buffer
        bound down from the upper one."""
        out = []
        for s, dev in enumerate(self.mesh.devices):
            lo, hi = self._neighbour(s, a, -1), self._neighbour(s, a, 1)
            pieces = [parts[s]] + ([ups[lo]] if lo is not None else []) + (
                [downs[hi]] if hi is not None else [])
            out.append(_cat_to(pieces, dev))
        return out

    # -- placement ---------------------------------------------------------
    def bind(self, state: SimState) -> list[SimState]:
        """A global state -> the list of shards: static boundary volumes
        computed once, the cuts, the rows of a shard sized from the worst
        shard of the bind-time distribution, the particles placed, the
        buffer caps measured."""
        res = self.spec.res
        if any(res[a] < self.sizes[a] for a in range(self.n_ax)):
            raise ValueError(f"grid {res} too small for a {'x'.join(map(str, self.sizes))} mesh")
        state = _state_to(state, self.mesh.devices[0])
        if self._flags is None:
            self._counts = torch.zeros(self.n_shards, dtype=torch.int64, device=state.device)
            self._flags = torch.zeros(4, dtype=torch.int64, device=state.device)
        if self.boundary_mode == "static" and bool(state.boundary_mask.any()):
            state = self._precompute_boundary_volumes(state)
        self._make_cuts(state)
        counts = self._counts_of(state).tolist()
        mean = -(-state.capacity // self.n_shards)
        rows = max(int(max(counts) * max(self.balance_slack, 1.1)),
                   int(mean * self.balance_slack), BLOCK + 256)
        self.shard_rows = -(-rows // BLOCK) * BLOCK
        shards = self._distribute(state, ValueError)
        self._measure_buffers(state)
        self._flags.zero_()
        self._bound = True
        return shards

    def _make_cuts(self, state: SimState) -> None:
        """Equal-count quantile cuts of the state's particles along each
        mesh axis, made strictly increasing in [1, res - 1] so every
        interval owns a cell (cell neighbours must be mesh neighbours); one
        read of the sum(S_a - 1) cuts."""
        spec = self.spec
        coords = gridops.cell_coords(state.x, spec)
        act = state.active_mask
        n_act = act.sum()
        big = torch.iinfo(torch.int32).max
        outs = []
        for a in range(self.n_ax):
            ca = torch.sort(torch.where(act, coords[:, a], big)).values
            q = torch.arange(1, self.sizes[a], device=ca.device) * n_act // self.sizes[a]
            outs.append(ca[torch.clamp(q, 0, state.capacity - 1)])
        cuts_all = torch.cat(outs).tolist()
        self._tables, self._lo, self._hi = [], [], []
        o = 0
        for a in range(self.n_ax):
            k, res_a = self.sizes[a] - 1, spec.res[a]
            cuts = sorted(int(c) for c in cuts_all[o:o + k])
            o += k
            for i in range(k):  # strictly increasing, >= 1
                cuts[i] = max(cuts[i], 1 if i == 0 else cuts[i - 1] + 1)
            for i in range(k - 1, -1, -1):  # room for the cuts after it
                cuts[i] = min(cuts[i], res_a - (k - i))
            edges = [0] + cuts + [res_a]
            self._tables.append(tuple(int(v) for v in np.searchsorted(cuts, np.arange(res_a),
                                                                      side="right")))
            self._lo.append(edges[:-1])
            self._hi.append(edges[1:])
        self._cuts_made += 1

    def _counts_of(self, state: SimState) -> torch.Tensor:
        """(n_shards,) live particles of each shard under the current cuts."""
        lin, _ = self._shard_of(gridops.cell_coords(state.x, self.spec))
        act = state.active_mask
        return torch.zeros(self.n_shards, dtype=torch.int64, device=lin.device).index_add_(
            0, lin, act.to(torch.int64))

    def _distribute(self, state: SimState, error) -> list[SimState]:
        """A global state's live particles placed in their shards, each
        sorted by cell id (stable) with an inactive tail; raises ``error``
        when a shard has more particles than rows."""
        spec, S, rows = self.spec, self.n_shards, self.shard_rows
        coords = gridops.cell_coords(state.x, spec)
        ids = gridops.flat_cell_ids(coords, state.material, spec)
        lin = torch.where(state.active_mask, self._shard_of(coords)[0], S)
        _, perm = torch.sort(lin * (spec.num_cells + 1) + ids.to(torch.int64), stable=True)
        counts = torch.zeros(S + 1, dtype=torch.int64, device=lin.device).index_add_(
            0, lin, torch.ones_like(lin)).tolist()[:S]
        if max(counts) > rows:
            raise error(f"a shard holds {max(counts)} particles, more than its {rows} rows; "
                        f"raise balance_slack (= {self.balance_slack}) or use more shards")
        shards, start = [], 0
        for n, dev in zip(counts, self.mesh.devices):
            st = gridops.gather_state(state, perm[start:start + n])
            start += n
            st = pad_state_capacity(dataclasses.replace(st, num_active=n), rows)
            shards.append(_state_to(st, dev))
        self._counts.copy_(torch.tensor(counts, dtype=torch.int64))
        return shards

    def _measure_buffers(self, state: SimState) -> None:
        """The halo and migration caps from the worst shard's pools of the
        state's distribution (``domain2d.py:469-567``), one read.

        A halo stage along axis a selects from the own rows and the halo
        rows of every later axis (the stages run last axis first), so its
        pool counts, for each subset T of the later axes and each direction
        of each, the rows in a's edge layer and in every edge layer of T,
        shifted to the shard that holds them at that stage; migration runs
        first axis first, so its pools ride the earlier axes.  Counting
        the own edge rows alone misses the corners."""
        spec, sizes, n_ax = self.spec, self.sizes, self.n_ax
        coords = gridops.cell_coords(state.x, spec)
        act = state.active_mask
        lin, per_axis = self._shard_of(coords)
        dev = lin.device

        def counts(mask):
            return torch.zeros(self.n_shards, dtype=torch.int64, device=dev).index_add_(
                0, lin, mask.to(torch.int64)).reshape(sizes)

        def edge(a, d):
            lo = device_constant(self._lo[a], torch.int64, dev)[per_axis[a]]
            hi = device_constant(self._hi[a], torch.int64, dev)[per_axis[a]]
            return act & (coords[:, a] == (hi - 1 if d > 0 else lo))

        def shift(arr, b, db):  # sender (.., i, ..) -> receiver (.., i + db, ..) along b
            out = torch.zeros_like(arr)
            src = [slice(None)] * n_ax
            dst = [slice(None)] * n_ax
            src[b], dst[b] = (slice(0, -1), slice(1, None)) if db > 0 else (
                slice(1, None), slice(0, -1))
            out[tuple(dst)] = arr[tuple(src)]
            return out

        def pool_worst(a, ride):
            worst = []
            for d_a in (1, -1):
                pool = torch.zeros(sizes, dtype=torch.int64, device=dev)
                for r in range(len(ride) + 1):
                    for T in itertools.combinations(ride, r):
                        for dirs in itertools.product((1, -1), repeat=r):
                            m = edge(a, d_a)
                            for b, db in zip(T, dirs):
                                m = m & edge(b, db)
                            c = counts(m)
                            for b, db in zip(T, dirs):
                                c = shift(c, b, db)
                            pool = pool + c
                worst.append(pool.max())
            return torch.maximum(*worst)

        vals = torch.stack([pool_worst(a, list(range(a + 1, n_ax))) for a in range(n_ax)]
                           + [pool_worst(a, list(range(a))) for a in range(n_ax)]).tolist()
        cap = lambda v: max(BLOCK, -(-int(v * self.buffer_slack) // BLOCK) * BLOCK)  # noqa: E731
        self.cap_h = [cap(v) for v in vals[:n_ax]]
        self.cap_m = [cap(v) for v in vals[n_ax:]]

    def shard_state(self, state: SimState) -> list[SimState]:
        """A global state's particles placed in their shards under the
        current cuts."""
        return self._distribute(_state_to(state, self.mesh.devices[0]), ValueError)

    def gather_state(self, shards: list[SimState]) -> SimState:
        """The global state on shard 0's device: every shard's live rows in
        shard order, then an inactive tail to ``n_shards * shard_rows``
        rows (for metrics, checkpoints and export)."""
        dev0 = self.mesh.devices[0]
        fields = {k: _cat_to([getattr(st, k)[:st.num_active] for st in shards], dev0)
                  for k in gridops.state_fields(shards[0])}
        st = SimState(**fields, num_active=sum(st.num_active for st in shards))
        return pad_state_capacity(st, self.n_shards * self.shard_rows)

    # -- the payload of migration ------------------------------------------
    def _pack(self, st: SimState) -> torch.Tensor:
        """(rows, C) i32: the bits of every field, a column per component."""
        return torch.cat([getattr(st, k).view(torch.int32).reshape(st.capacity, -1)
                          for k in gridops.state_fields(st)], dim=1)

    def _unpack(self, payload: torch.Tensor, like: SimState) -> SimState:
        """The fields of a payload (contiguous copies), as ``like``'s."""
        fields, c = {}, 0
        for k in gridops.state_fields(like):
            t = getattr(like, k)
            w = t.shape[1] if t.dim() == 2 else 1
            col = payload[:, c:c + w].contiguous().view(t.dtype)
            fields[k] = col if t.dim() == 2 else col.reshape(-1)
            c += w
        return SimState(**fields, num_active=0)

    def _decode(self, payload: torch.Tensor, like: SimState):
        """(x, material, material's column) of a payload."""
        cols, c = {}, 0
        for k in gridops.state_fields(like):
            t = getattr(like, k)
            cols[k] = c
            c += t.shape[1] if t.dim() == 2 else 1
        x0, m = cols["x"], cols["material"]
        return payload[:, x0:x0 + self.spec.dim].view(torch.float32), payload[:, m], m

    # -- one R-group ---------------------------------------------------------
    def _migrate(self, shards):
        """Each shard's payload after the per-axis migration phases, and
        per shard () i64 the rebuild's migration trips (rows more than one
        shard from home, rows a full buffer left in place)."""
        spec, devs = self.spec, self.mesh.devices
        like = shards[0]
        pays = [self._pack(st) for st in shards]
        trips = [torch.zeros((), dtype=torch.int64, device=d) for d in devs]
        for a in range(self.n_ax):
            ups, downs = [None] * self.n_shards, [None] * self.n_shards
            for s, dev in enumerate(devs):
                x, mat, mat_col = self._decode(pays[s], like)
                act = mat != MATERIAL_INVALID
                coords = gridops.cell_coords(x, spec)
                target = self._shard_of(coords)[1][a]
                d = torch.where(act, target - self._index[s][a], 0)
                trips[s] = trips[s] + (d.abs() > 1).sum()
                gone = torch.zeros_like(act)
                for step, sent in ((1, ups), (-1, downs)):
                    if self._neighbour(s, a, step) is None:
                        continue
                    idx, valid, taken, over = _select(d * step > 0, self.cap_m[a])
                    buf = pays[s].index_select(0, idx)
                    buf[:, mat_col].masked_fill_(~valid, MATERIAL_INVALID)
                    sent[s] = buf
                    trips[s] = trips[s] + over
                    gone = gone | taken
                # only the rows a buffer took leave: an overflow row stays
                pays[s][:, mat_col].masked_fill_(gone, MATERIAL_INVALID)
            pays = self._exchange(pays, ups, downs, a)
        return pays, trips

    def _build(self, shards):
        """Migration, each shard's sort and cut (the rebuild kernel), the
        halo stages, the id merge and its bounds (kernel B)."""
        spec, rows, devs = self.spec, self.shard_rows, self.mesh.devices
        sentinel = spec.num_cells
        pays, trips = self._migrate(shards)
        new, own_ids, stats = [], [], []
        for s, dev in enumerate(devs):
            x, mat, _ = self._decode(pays[s], shards[s])
            ids = gridops.flat_cell_ids(gridops.cell_coords(x, spec), mat, spec)
            sorted_ids, perm = torch.sort(ids, stable=True)
            live = (ids < sentinel).sum()
            st, _ = cuda_bounds.gather_and_bound(self._unpack(pays[s], shards[s]),
                                                 sorted_ids[:rows], perm[:rows], spec)
            new.append(dataclasses.replace(st, num_active=shards[s].num_active))
            own_ids.append(sorted_ids[:rows])
            stats.append([live, torch.clamp(live - rows, min=0), trips[s]])

        # the halo: last axis first, each stage selecting from the own rows
        # and the halo rows the later stages brought
        ext = [torch.stack([ids, st.material], dim=1) for ids, st in zip(own_ids, new)]
        stages = [[None] * self.n_ax for _ in devs]
        over_h = [torch.zeros((), dtype=torch.int64, device=d) for d in devs]
        for a in range(self.n_ax - 1, -1, -1):
            ups, downs = [None] * self.n_shards, [None] * self.n_shards
            for s in range(self.n_shards):
                ids = ext[s][:, 0]
                c_a = gridops.coords_from_ids(ids, spec)[:, a]
                act = ids < sentinel
                i_a = self._index[s][a]
                srcs = []
                for step, layer, sent in ((1, self._hi[a][i_a] - 1, ups),
                                          (-1, self._lo[a][i_a], downs)):
                    if self._neighbour(s, a, step) is None:
                        srcs.append(None)
                        continue
                    idx, valid, _, over = _select(act & (c_a == layer), self.cap_h[a])
                    buf = ext[s].index_select(0, idx)
                    buf[:, 0].masked_fill_(~valid, sentinel)
                    buf[:, 1].masked_fill_(~valid, MATERIAL_INVALID)
                    sent[s] = buf
                    srcs.append(idx)
                    over_h[s] = over_h[s] + over
                stages[s][a] = tuple(srcs)
            ext = self._exchange(ext, ups, downs, a)

        caches = []
        for s, st in enumerate(new):
            ids_e, perm_e = torch.sort(ext[s][:, 0], stable=True)
            where = torch.empty_like(perm_e).scatter_(
                0, perm_e, torch.arange(perm_e.shape[0], device=perm_e.device))
            fluid, bd = st.fluid_mask, st.boundary_mask
            flm, effm = group_masses(st, fluid, bd, self.params.density0)
            caches.append(RectCache(
                ids_e, cuda_bounds.csr_bounds_sorted(ids_e, spec),
                ext[s][:, 1].index_select(0, perm_e), where[:rows].to(torch.int32),
                fluid, bd, effm, flm, tuple(stages[s]), perm_e))
            stats[s].append(over_h[s])

        # [live, dropped, migration trips, halo overflow] per shard, folded
        # into the flags on shard 0's device
        per = _cat_to([torch.stack(v)[None] for v in stats], devs[0])
        self._counts.copy_(per[:, 0])
        self._flags.copy_(torch.stack([
            torch.maximum(self._flags[0], per[:, 0].max()), self._flags[1] + per[:, 1].sum(),
            self._flags[2] + (per[:, 2].sum() > 0), torch.maximum(
                self._flags[3], (per[:, 3].sum() > 0).to(torch.int64))]))
        return new, caches

    def _halo(self, parts, caches):
        """The value-only refresh of one pack: the build's stages from the
        cached row sources, then its id merge."""
        cur = list(parts)
        for a in range(self.n_ax - 1, -1, -1):
            ups, downs = [None] * self.n_shards, [None] * self.n_shards
            for s, c in enumerate(caches):
                up, down = c.stages[a]
                if up is not None:
                    ups[s] = cur[s].index_select(0, up)
                if down is not None:
                    downs[s] = cur[s].index_select(0, down)
            cur = self._exchange(cur, ups, downs, a)
        return [t.index_select(0, c.perm) for t, c in zip(cur, caches)]

    def _capture_key(self) -> tuple:
        """Beyond ``SolverBase``'s: the shard rows, the caps (the shapes
        ``_select`` gives), the cuts (the cell-to-shard tables and the
        edge layers a build reads), which ``run``'s steering changes, and
        the room test's share of the rows."""
        return super()._capture_key() + (self.shard_rows, tuple(self.cap_h),
                                         tuple(self.cap_m), self._cuts_made, self.emit_frac)

    def _inplace(self) -> tuple[torch.Tensor, ...]:
        held = (self._counts, self._flags)
        return held if self._emitted_rows is None else held + (self._emitted_rows,)

    def _groups(self, carry, num_steps, R, substep, emit=None):
        """``SolverBase._groups``, then the call's one read: each shard's
        live rows, the emitters' emitted rows, and a raise if the fixed cut
        dropped any row."""
        ems = list(carry[1]) if emit is not None else []
        if ems:  # the device counters start from the host's, filled on the stream
            dev0 = self.mesh.devices[0]
            if self._emitted_rows is None or self._emitted_rows.shape[0] != len(ems):
                self._emitted_rows = torch.zeros(len(ems), dtype=torch.int64, device=dev0)
            for e, es in enumerate(ems):
                self._emitted_rows[e].fill_(es.emitted)
        carry = super()._groups(carry, num_steps, R, substep, emit)
        S = self.n_shards
        vals = torch.cat([self._counts, self._flags[1:2]]
                         + ([self._emitted_rows] if ems else [])).tolist()
        if vals[S]:
            raise RuntimeError(f"the fixed cut to {self.shard_rows} rows a shard dropped "
                               f"{vals[S]} particles; rebind with a larger balance_slack "
                               f"(= {self.balance_slack}) or more shards")
        shards = [dataclasses.replace(st, num_active=n) for st, n in zip(carry[0], vals[:S])]
        if ems:
            return shards, [dataclasses.replace(es, emitted=n)
                            for es, n in zip(carry[1], vals[S + 1:])]
        return (shards,) + tuple(carry[1:])

    # -- emitters: each shard's own tail -----------------------------------
    def _emit_batch(self, shards, es: EmitterState, e: int, start=None) -> list[SimState]:
        """Emitter ``e``'s due batch, all or none, decided on the device
        (``domain2d.py:962-1059``): each shard takes the seeds whose cell it
        owns into its own tail, and the batch fires only if every shard
        stays within ``emit_frac`` of its rows (the share ``run``
        rebalances at, so emission never eats the migrants' headroom) and
        the quota allows.  A batch that does not fire is written to a
        dropped row (``activate_rows``); the live-row counts and the
        emitter's emitted rows grow in place by what fired."""
        S, rows, b = self.n_shards, self.shard_rows, es.batch_size
        dev0 = self._counts.device
        seeds = es.seeds_x.to(dev0, non_blocking=True)
        lin = self._shard_of(gridops.cell_coords(seeds, self.spec))[0]
        owned = lin[None, :] == torch.arange(S, device=dev0)[:, None]  # (S, b)
        k = owned.sum(1)
        fire = ((self._counts + k) <= int(self.emit_frac * rows)).all()
        if es.max_particles > 0:
            fire = fire & (self._emitted_rows[e] + b <= es.max_particles)
        at = torch.where(owned & fire, self._counts[:, None] + torch.cumsum(owned, 1) - 1, rows)
        out = []
        for s, (st, dev) in enumerate(zip(shards, self.mesh.devices)):
            fields = activate_rows(
                {f: getattr(st, f) for f in EMIT_FIELDS}, at[s].to(dev, non_blocking=True),
                seeds.to(dev, non_blocking=True), es.velocity.to(dev), es.color.to(dev),
                es.density.to(dev), self.scene.particle_volume0)
            out.append(dataclasses.replace(st, **fields))
        self._counts.add_(k * fire)
        self._emitted_rows[e].add_(fire.to(torch.int64) * b)
        return out

    # -- adaptive run and metrics --------------------------------------------
    def regrow_buffers(self, factor: float = 2.0, kinds: tuple[str, ...] = ("h", "m")) -> None:
        """Deepen the halo (``"h"``) and/or migration (``"m"``) caps."""
        for kind in kinds:
            caps = self.cap_h if kind == "h" else self.cap_m
            caps[:] = [max(BLOCK, -(-int(c * factor) // BLOCK) * BLOCK) for c in caps]

    def rebalance(self, shards: list[SimState]) -> list[SimState]:
        """New cuts at the current distribution's quantiles, the particles
        placed anew and the caps measured again (the shard occupancy neared
        ``shard_rows``)."""
        state = self.gather_state(shards)
        self._make_cuts(state)
        shards = self._distribute(state, RuntimeError)
        self._measure_buffers(state)
        self._flags[0] = 0
        return shards

    def reset_flags(self) -> None:
        """The flags of ``metrics`` back to 0 (in place)."""
        self._flags.zero_()

    def run(self, shards, num_steps: int, check_every: int = 400, *, verbose: bool = False,
            warn_frac: float = 0.9) -> list[SimState]:
        """``SolverBase.run``, and after each chunk one read of the flags
        (``_after_chunk``); ``warn_frac``: the busiest shard's share of its
        rows past which the cuts are rebalanced."""
        return self._run_chunks((shards,), num_steps, self._roll, check_every, verbose,
                                warn_frac=warn_frac)[0]

    def run_coupled(self, shards, rigid: RigidState, num_steps: int, check_every: int = 400,
                    *, verbose: bool = False, warn_frac: float = 0.9):
        """``run`` over the ``(shards, rigid)`` carry with
        ``rollout_coupled``; a rebalance passes the bodies through."""
        return self._run_chunks((shards, rigid), num_steps, self._roll_coupled, check_every,
                                verbose, warn_frac=warn_frac)

    def _after_chunk(self, carry: tuple, k: int, verbose: bool, warn_frac: float) -> tuple:
        """One read of the flags: the busiest shard past ``warn_frac`` of
        its rows rebalances the cuts, a halo overflow deepens the halo caps,
        a migration trip the migration caps (``domain2d.py:1178-1256``,
        without the window and row-pad caps, which the port has not)."""
        shards = carry[0]
        busiest, _, trips, halo = self._flags.tolist()
        if busiest > warn_frac * self.shard_rows:
            if verbose:
                print(f"[tisph] shard occupancy {busiest}/{self.shard_rows}; rebalancing")
            shards = self.rebalance(shards)
        if halo:
            old = list(self.cap_h)
            self.regrow_buffers(kinds=("h",))
            if verbose:
                print(f"[tisph] rect halo buffer overflow at caps {old}; now {self.cap_h}")
        if trips:
            old = list(self.cap_m)
            self.regrow_buffers(kinds=("m",))
            if verbose:
                print(f"[tisph] {trips} rebuilds with clamped or anomalous migration at "
                      f"caps {old}; now {self.cap_m}")
        self.reset_flags()
        return (shards,) + tuple(carry[1:])

    def metrics(self, shards) -> dict[str, float | int]:
        """``SolverBase.metrics`` of the global state, plus the flags since
        the last reset (``occ_halo``, ``migrate_anomalies``: rebuilds with a
        migration trip, ``shard_rows_used``: the busiest shard's live rows,
        ``dropped_rows``), ``shard_rows`` and the halo caps' rows."""
        out = super().metrics(self.gather_state(shards))
        busiest, dropped, trips, halo = self._flags.tolist()
        return out | {"occ_halo": halo, "migrate_anomalies": trips, "shard_rows_used": busiest,
                      "dropped_rows": dropped, "shard_rows": self.shard_rows,
                      "halo_buf_rows": sum(self.cap_h)}


# the 2-axis decomposition is the common case; the class takes 2- or 3-axis
# meshes alike, so the reference's name is an alias
ShardedWCSPH2D = ShardedWCSPHRect
