"""WCSPHRigid: WCSPH with dynamic rigid bodies (two-way coupling).

The step carries the pair ``(SimState, RigidState)``.  Per R-group the
WCSPH rebuild (stable sort by cell, CSR bounds); every substep, as
``tisph_tpu``'s seg coupled rollout runs it (``WCSPHRigid
._coupled_apply_pack`` over ``WCSPH._seg_apply_pack(with_reactions=True)``):

1. bvol sweep on current positions with the group's sort-time structure,
   V = 1 / max(delta, 1e-10) and effm = fl m + bd rho0 V on boundary rows;
2. density sweep (boundary rows keep their density) and the Tait EOS;
3. force_react sweep: dv on fluid rows, the fluid -> boundary reaction
   force on boundary rows;
4. symplectic Euler and the domain-box clamp on fluid rows;
5. ``integrate_rigid_fields`` on body rows.

The staleness argument of the R-group rebuild (``models.wcsph``) extends
to the moving body particles: both sides of the candidate test use
sort-time ids, and body motion is CFL-bounded like the fluid's.
"""

from __future__ import annotations

import dataclasses

from tisph_tpu_torch.config import SceneConfig
from tisph_tpu_torch.geometry.emitter import EmitterState
from tisph_tpu_torch.models.rigid import RigidState, integrate_rigid_fields, make_rigid_state
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.models.wcsph import GroupCache, WCSPH


class WCSPHRigid(WCSPH):
    boundary_mode = "per_step"  # the bodies move
    # tisph_tpu's coupled step off the seg layout runs its blocked jnp
    # sweeps, not the linear kernel (wcsph_rigid.py:42-72), and the linear
    # kernel has no force_react mode: a dynamic scene refuses "linear"
    layouts = ("seg",)

    def __init__(self, scene: SceneConfig, **kw):
        super().__init__(scene, **kw)
        if self.boundary_mode != "per_step":
            raise ValueError("dynamic rigid bodies need boundary_mode='per_step'")

    def init_rigid(self, state: SimState) -> RigidState:
        """Bodies at rest, mass and COM from ``state``'s particles."""
        return make_rigid_state(state, self.scene)

    def _coupled_substep(self, carry: tuple, cache: GroupCache) -> tuple:
        state, rigid = carry
        state, reactions = self._apply(state, cache, with_reactions=True)
        x, v, rigid = integrate_rigid_fields(state.x, state.v, state.mass, state.object_id,
                                             cache.boundary, rigid, reactions, self.params)
        return dataclasses.replace(state, x=x, v=v), rigid

    def _check_rigid(self, state: SimState, rigid: RigidState) -> None:
        if rigid.com.device != state.device:
            raise ValueError(f"rigid state is on {rigid.com.device}, particles on {state.device}")

    def step_coupled(self, state: SimState, rigid: RigidState) -> tuple[SimState, RigidState]:
        """One coupled substep with a fresh neighbour structure."""
        self._check_rigid(state, rigid)
        return self._groups((state, rigid), 1, 1, self._coupled_substep)

    def rollout_coupled(self, state: SimState, rigid: RigidState,
                        num_steps: int) -> tuple[SimState, RigidState]:
        """``num_steps`` coupled substeps in groups of ``resort_every``."""
        self._check_rigid(state, rigid)
        return self._groups((state, rigid), num_steps, self.resort_every,
                            self._coupled_substep)

    def run_coupled(self, state: SimState, rigid: RigidState, num_steps: int,
                    check_every: int = 400, *, verbose: bool = False
                    ) -> tuple[SimState, RigidState]:
        """``SolverBase.run`` over the ``(state, rigid)`` carry with
        ``rollout_coupled``; binds an unbound state first."""
        if not self._bound:
            state = self.bind(state)
        return self._run_chunks((state, rigid), num_steps, self._roll_coupled, check_every,
                                verbose)


def make_solver(scene: SceneConfig, state: SimState,
                **kw) -> tuple[WCSPH, SimState, RigidState | None]:
    """The solver ``scene`` runs on, bound to ``state``, as
    ``examples/run_scene.py`` dispatches: ``WCSPHRigid`` and its bodies at
    rest when any rigid body is dynamic, else ``WCSPH`` (static bodies are
    boundary particles) and None.  ``kw`` goes to the solver.  A scene with
    a dynamic body and emitters raises: the coupled step has no emission
    (``examples/run_scene.py`` drops the emitters of such a scene)."""
    if any(rb.is_dynamic for rb in scene.rigid_bodies):
        if scene.emitters:
            raise ValueError("a scene with dynamic rigid bodies and emitters is not supported: "
                             "the coupled step does not emit")
        solver = WCSPHRigid(scene, **kw)
        state = solver.bind(state)
        return solver, state, solver.init_rigid(state)
    solver = WCSPH(scene, **kw)
    return solver, solver.bind(state), None


def advance(solver: WCSPH, state: SimState, rigid: RigidState | None, num_steps: int,
            emitters: list[EmitterState] | None = None
            ) -> tuple[SimState, RigidState | None, list[EmitterState] | None]:
    """``num_steps`` substeps of a :func:`make_solver` solver, returning
    ``(state, rigid, emitters)``: the coupled rollout when ``rigid`` is
    not None, ``rollout_emit`` when ``emitters`` is not None (the two
    together raise: the coupled step does not emit), else the plain
    rollout."""
    if emitters is not None:
        if rigid is not None:
            raise ValueError("the coupled step does not emit: emitters with dynamic bodies")
        state, emitters = solver.rollout_emit(state, emitters, num_steps)
        return state, None, emitters
    if rigid is None:
        return solver.rollout(state, num_steps), None, None
    return (*solver.rollout_coupled(state, rigid, num_steps), None)
