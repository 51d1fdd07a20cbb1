"""Solver base: bind, step, the R-group rollout schedule and metrics.

Counterpart of ``tisph_tpu.models.solver_base.SolverBase`` for one device.
PyTorch runs eagerly, so a rollout is a Python loop over R-groups: the
neighbour structure (cell sort and CSR bounds) is rebuilt once per group
of ``resort_every`` substeps and reused by the substeps in between, and
the last group takes the remainder (``solver_base.py:261-326``).  With
R = 1 every substep rebuilds, the reference's cadence.

``rollout_emit`` adds the emitters with ``tisph_tpu``'s two schedules
(``solver_base.py:338-390``): at R = 1 each step emits, then rebuilds, then
applies; at R > 1 each group rebuilds once, then every substep emits and
applies, so a batch emitted inside a group joins the neighbour structure
at the next rebuild.

On a CUDA ``WCSPH``, ``WCSPHRigid`` or ``WCSPHLegacy`` each R-group of ``step``,
``rollout``, ``rollout_emit``, ``run`` and the coupled ones is one replay
of a CUDA graph (``models.graphs``, the counterpart of ``tisph_tpu``'s
jitted rollout), and so is a group of the slab and the rectangle
decompositions whose shards share one card; ``graphs=False`` keeps the
eager loop, which the CPU and every class whose group reads the host
(``eager_loop``) run.  The emitters' cadence counts on the host, which
knows all it depends on; where a batch fires is decided on the host too
(``_emit_batch`` writes it from a start row), except on the rectangle,
whose room test runs on the device (``emit_on_device``).

``run`` (and every solver's ``run_coupled``) is the long-run entry point:
``rollout`` in chunks of ``check_every`` steps through the one chunk loop
``_run_chunks``, with a per-chunk hook ``_after_chunk`` in which the
sharded solvers read their flags and steer (``solver_base.py:392-583``).
``tisph_tpu``'s window and row-pad caps, their ``regrow`` and its
watchdog chunking are not ported: the port's sweeps walk every stencil
run to its end with no cap, so on one device a chunk reads nothing.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from tisph_tpu_torch.config import SceneConfig, SolverParams
from tisph_tpu_torch.geometry.emitter import EmitterState, activate, count_step, due_step
from tisph_tpu_torch.models.graphs import GroupRunner
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.ops.cuda import build as cuda_build
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.ops.neighbors import pack4
from tisph_tpu_torch.utils.profiling import count, launches, span, sweep_rows


class SolverBase:
    """Static configuration (SolverParams, GridSpec, device, R) plus the
    step; all simulation state lives in :class:`SimState`."""

    # the default of ``boundary_mode`` (see __init__)
    boundary_mode = "static"
    # sweep layouts the solver runs (see __init__)
    layouts = ("seg", "linear")
    # why the class's R-group runs the eager loop, or None when it reads
    # nothing on the host and replays as one CUDA graph (models.graphs)
    eager_loop: str | None = "the base class's group is not known to be capturable"
    # whether a due batch fires by a test on the device (the rectangle's
    # room test) rather than by the host's count (see ``_maybe_emit``)
    emit_on_device = False

    def __init__(
        self,
        scene: SceneConfig,
        compat: str = "reference",
        device: str | torch.device = "cuda",
        resort_every: int = 1,
        fast_math: bool = True,
        layout: str = "seg",
        boundary_mode: str | None = None,
        params: SolverParams | None = None,
        graphs: bool | None = None,
    ):
        """``resort_every``: substeps per neighbour-structure rebuild (R).
        ``fast_math``: approximate reciprocals on the gradient sweeps'
        viscosity-only divides in the CUDA kernels (no effect on the CPU).
        ``layout``: the density and force sweeps' kernel, the counterpart
        of ``tisph_tpu``'s ``SweepConfig.layout``: ``"seg"``, a thread per
        row over its own stencil runs (csrc/sweeps.cu), or ``"linear"``,
        blocks of 128 rows over shared windows (csrc/sweeps_linear.cu),
        which runs at R = 1 only, as ``tisph_tpu`` applies R > 1 only on the
        seg layout.
        ``boundary_mode``: ``"static"`` computes the Akinci boundary volumes
        once at bind (boundary particles never move); ``"per_step"`` every
        substep on current positions, as the reference does
        (sph_basev2.py:212), which moving bodies need.  None takes the
        class's default.
        ``params``: the physics parameters; None takes
        ``SolverParams.from_scene(scene, compat)``.
        ``graphs``: each R-group one CUDA graph replay (``models.graphs``);
        None is on for a CUDA solver whose class allows it (``eager_loop``
        None), False the eager loop, True raises where the graph path does
        not run (the CPU, such a class)."""
        if boundary_mode is None:
            boundary_mode = type(self).boundary_mode
        if boundary_mode not in ("static", "per_step"):
            raise ValueError(f"unknown boundary_mode {boundary_mode!r}")
        self.boundary_mode = boundary_mode
        if layout not in self.layouts:
            raise ValueError(f"{type(self).__name__} runs the layouts {self.layouts}, "
                             f"not {layout!r}")
        self.layout = layout
        self._check_resort(resort_every)
        self.scene = scene
        self.params = params if params is not None else SolverParams.from_scene(scene, compat)
        self.device = torch.device(device)
        self.resort_every = int(resort_every)
        self.fast_math = bool(fast_math)
        self.spec = gridops.make_grid_spec(
            dim=scene.dim,
            domain_start=scene.domain_start,
            domain_end=scene.domain_end,
            support_length=scene.support_length,
        )
        self._bound = False
        if graphs and self.eager_loop is not None:
            raise ValueError(f"graphs=True: {type(self).__name__} runs the eager loop "
                             f"({self.eager_loop})")
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, the solver is on {self.device}")
        if graphs is None:
            graphs = self.device.type == "cuda" and self.eager_loop is None
        self.graphs = bool(graphs)
        self._runner: GroupRunner | None = None
        # the fluid and boundary rows of the state last bound, as host ints
        self._bind_rows: dict[str, int] = {}

    def _check_resort(self, R: int) -> None:
        if R < 1:
            raise ValueError(f"resort_every must be >= 1, got {R}")
        if R > 1 and self.layout == "linear":
            raise ValueError(f"resort_every={R}: the linear layout rebuilds every substep "
                             "(R = 1); R > 1 needs layout='seg'")

    def _check_device(self, state: SimState) -> None:
        dev = state.device
        if dev.type != self.device.type or (
            self.device.index is not None and dev.index != self.device.index
        ):
            raise ValueError(f"state is on {dev}, solver on {self.device}")

    def bind(self, state: SimState) -> SimState:
        """Check the state's device, count its fluid and boundary rows (one
        device read) and, under ``boundary_mode="static"``, compute the
        Akinci boundary volumes once.  One ``solver.bind`` span (``rows``,
        ``fluid_rows``, ``boundary_rows``) and the counters ``bind.calls``,
        ``bind.s`` (host seconds to the device's finish: a bind that
        computed volumes waits for them) and ``bind.boundary_rows``."""
        self._check_device(state)
        if self.device.type == "cuda":
            cuda_build.load()  # a checkout's first build counts in build.s, not bind.s
        t0 = time.perf_counter()
        with span("solver.bind", rows=state.capacity) as sp:
            fluid, boundary = torch.stack([state.fluid_mask.sum(),
                                           state.boundary_mask.sum()]).tolist()
            self._bind_rows = {"fluid_rows": fluid, "boundary_rows": boundary}
            if sp is not None:
                sp.attrs.update(self._bind_rows)
            if self.boundary_mode == "static" and boundary:
                state = self._precompute_boundary_volumes(state)
                self.synchronize()
            self._bound = True
        count("bind.calls")
        count("bind.s", time.perf_counter() - t0)
        count("bind.boundary_rows", boundary)
        return state

    def _precompute_boundary_volumes(self, state: SimState) -> SimState:
        """V_b = 1 / (k_sig sum_{j boundary} w) on boundary rows
        (sph_basev2.py:190-201), by the sweep kernel's ``bvol`` mode;
        returned in the caller's (unsorted) order.  The caller makes sure
        the state has boundary rows."""
        spec, params = self.spec, self.params
        st, ids, perm, bounds = cuda_bounds.sort_and_bound(state, spec)
        bd = st.boundary_mask
        pos = pack4(st.x, bd.to(torch.float32))
        delta = cuda_sweeps.bvol_sweep(pos, ids, bounds, st.material, spec, params,
                                       self.fast_math)
        vol = torch.where(bd, 1.0 / torch.clamp(delta, min=1e-10), st.volume)
        volume = torch.empty_like(vol)
        volume[perm] = vol  # scatter back to the caller's order
        return dataclasses.replace(state, volume=volume)

    # -- provided by concrete solvers ------------------------------------
    def _build(self, state: SimState):
        raise NotImplementedError

    def _apply(self, state: SimState, cache) -> SimState:
        raise NotImplementedError

    def _substep(self, carry: tuple, cache) -> tuple:
        """One substep of the carry ``(state, ...)``; the rest of the carry
        passes through."""
        return (self._apply(carry[0], cache),) + tuple(carry[1:])

    def _capture_key(self) -> tuple:
        """What a captured group bakes in beyond the carry's shapes (part
        of ``GroupRunner.key``)."""
        return (self.layout, self.boundary_mode, self.fast_math, self.params, self.spec)

    def _inplace(self) -> tuple[torch.Tensor, ...]:
        """Tensors outside the carry that a group updates in place: a
        graph keeps their addresses, and its warm-up restores them."""
        return ()

    def _capacity(self, state: SimState) -> int:
        """Rows the emitters' pool may fill."""
        return state.capacity

    def _with_live(self, state: SimState, num_active: int) -> SimState:
        """``state`` holding ``num_active`` live rows, first."""
        return dataclasses.replace(state, num_active=num_active)

    def _emit_batch(self, state: SimState, es: EmitterState, e: int, start) -> SimState:
        """``state`` with emitter ``e``'s batch ``es`` in rows ``[start,
        start + b)``; ``start`` is a host int on the eager loop and a 0-d
        device tensor in a replay (``models.graphs``), the same rows."""
        return activate(state, es, start, self.scene.particle_volume0)

    def _maybe_emit(self, carry: tuple) -> tuple:
        """One step of every emitter on the carry ``(state, emitters)``:
        the host counts the step and, unless ``emit_on_device``, decides
        whether the batch fires (due, room in the pool, under the quota)
        and where (at the live rows' end), as ``geometry.emitter.
        maybe_emit``; with ``emit_on_device`` a due batch goes to
        ``_emit_batch``, which decides on the device."""
        part, ems = carry[0], list(carry[1])
        for e, es in enumerate(ems):
            start = None
            if self.emit_on_device:
                fire, ems[e] = due_step(es)
            else:
                start = self._num_particles(part)
                fire, ems[e] = count_step(es, start + es.batch_size <= self._capacity(part))
            if fire:
                part = self._emit_batch(part, es, e, start)
                if start is not None:
                    part = self._with_live(part, start + es.batch_size)
        return part, ems

    # -- public API ------------------------------------------------------
    def step(self, state: SimState) -> SimState:
        """One substep with a fresh neighbour structure."""
        return self._groups((state,), 1, 1, self._substep)[0]

    def rollout(self, state: SimState, num_steps: int) -> SimState:
        """``num_steps`` substeps in groups of ``resort_every``."""
        return self._groups((state,), num_steps, self.resort_every, self._substep)[0]

    def rollout_emit(self, state: SimState, emitters: list[EmitterState],
                     num_steps: int) -> tuple[SimState, list[EmitterState]]:
        """``num_steps`` substeps with the emitters, in groups of
        ``resort_every``; returns the state and the emitters' new states.
        A batch emitted inside a group is fluid from then on but joins no
        sweep until the next rebuild: it keeps its density, gets no
        acceleration and flies at its emission velocity, as in
        ``tisph_tpu`` (its ``keep = back_valid & fl``).  The emitters
        count on the host, and a batch's start row is ``num_active``, a
        host int (``geometry/emitter.py``; the rectangle decides on the
        device, ``emit_on_device``); on the graph path each group replays
        the graph of its fire pattern (``models.graphs``)."""
        return self._groups((state, list(emitters)), num_steps, self.resort_every,
                            self._substep, emit=self._maybe_emit)

    def _groups(self, carry: tuple, num_steps: int, R: int, substep, emit=None) -> tuple:
        """Run ``num_steps`` of ``substep(carry, cache) -> carry`` in groups
        of R, rebuilding the neighbour structure of ``carry[0]`` (the
        SimState, which the rebuild sorts) before each group.  ``emit(carry)
        -> carry`` runs once per substep: before the rebuild at R = 1,
        before each substep after it at R > 1.  With ``graphs`` the groups
        are replays of the runner's graphs, which emit on the same schedule
        (``carry`` then is ``(state, emitters)``).  The call is one
        ``solver.rollout`` span (``utils.profiling``), whose ``replays``,
        ``captures``, ``launches`` (the rise of the registry's launch
        counters) and ``sweep_rows`` (the rise of its ``rows.*``) are read
        at its end while recording, with the ``fluid_rows`` and
        ``boundary_rows`` of the last bind; each eager group is a
        ``solver.group`` span."""
        with span("solver.rollout", steps=num_steps, R=R) as sp:
            if sp is None:
                return self._group_loop(carry, num_steps, R, substep, emit)
            before = self._call_counts()
            carry = self._group_loop(carry, num_steps, R, substep, emit)
            sp.attrs.update({k: v - before[k] for k, v in self._call_counts().items()})
            sp.attrs.update(self._bind_rows)
            return carry

    def _call_counts(self) -> dict[str, int]:
        """The counts a ``solver.rollout`` span reports the rise of."""
        r = self._runner
        return {"launches": launches(), "sweep_rows": sweep_rows(),
                "replays": r.replays if r else 0, "captures": r.captures if r else 0}

    def _group_loop(self, carry: tuple, num_steps: int, R: int, substep, emit) -> tuple:
        """:meth:`_groups`' work: the runner's replays, or the eager loop."""
        self._check_resort(R)
        state = carry[0]
        if not self._bound:
            state = self.bind(state)
        self._check_device(state)
        carry = (state,) + tuple(carry[1:])
        if self.graphs:
            if self._runner is None:
                self._runner = GroupRunner(self)
            if emit is None:
                return self._runner.rollout(carry, num_steps, R, substep)
            return self._runner.rollout(carry[:1], num_steps, R, substep, emitters=carry[1])
        done = 0
        while done < num_steps:
            k = min(R, num_steps - done)
            with span("solver.group", k=k):
                if emit is not None and R == 1:
                    carry = emit(carry)
                state, cache = self._build(carry[0])
                carry = (state,) + tuple(carry[1:])
                for _ in range(k):
                    if emit is not None and R > 1:
                        carry = emit(carry)
                    carry = substep(carry, cache)
            done += k
        return carry

    # -- long runs -------------------------------------------------------
    def run(self, state: SimState, num_steps: int, check_every: int = 400, *,
            verbose: bool = False) -> SimState:
        """``num_steps`` substeps through ``rollout`` in chunks of
        ``check_every``.  A chunk that ends inside an R-group makes the
        next chunk start with a rebuild, as in ``tisph_tpu``: ``run(n,
        check_every=c)`` is ``rollout(n)`` when ``c % resort_every == 0``.
        ``verbose`` prints each chunk's particle-steps/s by the host clock
        between device synchronisations (which only ``verbose`` adds)."""
        return self._run_chunks((state,), num_steps, self._roll, check_every, verbose)[0]

    def _roll(self, carry: tuple, k: int) -> tuple:
        return (self.rollout(carry[0], k),)

    def _roll_coupled(self, carry: tuple, k: int) -> tuple:
        return self.rollout_coupled(*carry, k)

    def _run_chunks(self, carry: tuple, num_steps: int, roll, check_every: int,
                    verbose: bool, **opts) -> tuple:
        """The chunk loop of every ``run`` and ``run_coupled``: ``carry =
        roll(carry, k)`` for ``k = min(check_every, steps left)``, then
        ``carry = self._after_chunk(carry, k, verbose, **opts)``."""
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        done = 0
        while done < num_steps:
            k = min(check_every, num_steps - done)
            if verbose:
                self.synchronize()
                t0 = time.perf_counter()
            carry = roll(carry, k)
            if verbose:
                self.synchronize()
                wall = time.perf_counter() - t0
                n = self._num_particles(carry[0])
                print(f"[tisph] steps {done}-{done + k}: {wall:.4f} s, "
                      f"{n * k / wall:.6e} particle-steps/s ({n} particles)", flush=True)
            done += k
            carry = self._after_chunk(carry, k, verbose, **opts)
        return carry

    def _after_chunk(self, carry: tuple, k: int, verbose: bool) -> tuple:
        """What a chunk's end reads and steers: on one device nothing (no
        cap to read, so a chunk waits on nothing)."""
        return carry

    def _devices(self) -> tuple[torch.device, ...]:
        return (self.device,)

    def synchronize(self) -> None:
        """Wait for the work queued on the solver's CUDA devices."""
        for dev in set(self._devices()):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _num_particles(self, state: SimState) -> int:
        return state.num_active

    def metrics(self, state: SimState) -> dict[str, float | int]:
        """Max fluid speed, CFL number, mean and max relative fluid density
        error, live particle count and the count of non-finite x and v
        entries; one device-to-host copy (a ``solver.metrics`` span)."""
        params = self.params
        with span("solver.metrics"):
            fluid = state.fluid_mask
            zero = torch.zeros((), dtype=torch.float32, device=state.device)
            speed = torch.sqrt(torch.sum(state.v * state.v, dim=-1))
            vmax = torch.max(torch.where(fluid, speed, zero))
            rho_err = torch.where(
                fluid, torch.abs(state.density - params.density0) / params.density0, zero
            )
            nf = torch.clamp(fluid.sum(), min=1)
            nan = (~torch.isfinite(state.x)).sum() + (~torch.isfinite(state.v)).sum()
            vals = torch.stack([
                vmax, vmax * params.dt / params.support_length,
                rho_err.sum() / nf, rho_err.max(), nan.to(torch.float32),
            ]).tolist()
            return {
                "max_velocity": vals[0],
                "cfl": vals[1],
                "avg_density_error": vals[2],
                "max_density_error": vals[3],
                "num_active": state.num_active,
                "nan_count": int(vals[4]),
            }
