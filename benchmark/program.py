"""The system under test, ``tisph_tpu_torch``, as a cell drives it: the
solver a configuration names, its start state, ``advance``, the dump and
the health read.  The only module of the benchmark that imports it, and
the only one that reads a program state's fields: the harness holds a
state as an opaque carry and asks :class:`Program` for its rows.

The solver kinds (a configuration's ``solver``):

- ``wcsph``: ``tt.WCSPH``, static boundary rows; the carry is the
  ``SimState``;
- ``legacy``: ``tt.WCSPHLegacy``; the carry is the ``SimState``;
- ``rigid``: ``tt.WCSPHRigid``, as ``tt.make_solver`` dispatches a scene
  with a dynamic body: bound, with ``init_rigid`` of the bound S0; the
  carry is the pair ``(SimState, RigidState)``, advanced by
  ``tt.advance(solver, state, rigid, steps)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import inputs


def _reactions_scaled(solver_cls):
    """``solver_cls`` with the fluid -> body reactions scaled by 0.9
    between the force sweep and the bodies' sums: the fluid's own step is
    the program's, the bodies' is not."""
    class ReactionsScaled(solver_cls):
        def _apply(self, state, cache, with_reactions: bool = False):
            out = super()._apply(state, cache, with_reactions)
            return (out[0], 0.9 * out[1]) if with_reactions else out
    return ReactionsScaled


# faults planted in the program, for the readings the check's limits are
# set from (``benchmark.control --fault``); a run plants none.  Each takes
# the solver's parameters and class and gives back the pair to build.
FAULTS = {
    "viscosity_dropped": lambda p, cls: (dataclasses.replace(p, viscosity=0.0), cls),
    "pressure_scaled": lambda p, cls: (dataclasses.replace(p, stiffness=0.9 * p.stiffness),
                                       cls),
    # Akinci's boundary viscosity left out: no change without boundary rows
    "boundary_viscosity_dropped": lambda p, cls: (dataclasses.replace(p, boundary_sigma=0.0),
                                                  cls),
    # the bodies' share alone: no change without a dynamic body
    "reactions_scaled": lambda p, cls: (p, _reactions_scaled(cls)),
}

# the fields of a state that the check's replay has to repeat bitwise
REPLAYED = ("x", "v", "density", "pressure", "object_id")
RIGID_REPLAYED = ("com", "v_com", "omega")


class Program:
    """One solver of the configuration, built once and bound to each start
    state in turn (the same shapes, so its CUDA graphs stay captured);
    ``fault`` names one of :data:`FAULTS` to build it with."""

    def __init__(self, cell, device: torch.device, resort_every: int,
                 fault: str | None = None):
        import tisph_tpu_torch as tt

        self.tt = tt
        self.device = device
        self.scene = tt.load_scene(cell.scene_path)
        kind, compat = cell.config["solver"], cell.config["compat"]
        classes = {"wcsph": tt.WCSPH, "legacy": tt.WCSPHLegacy, "rigid": tt.WCSPHRigid}
        if kind not in classes:
            raise ValueError(f"unknown solver {kind!r}")
        dynamic = any(rb.is_dynamic for rb in self.scene.rigid_bodies)
        if dynamic != (kind == "rigid"):
            raise ValueError(f"the {kind} path of the benchmark takes "
                             + ("no dynamic bodies" if dynamic else "a dynamic body"))
        self.rigid = kind == "rigid"
        params, cls = tt.SolverParams.from_scene(self.scene, compat), classes[kind]
        if fault is not None:
            params, cls = FAULTS[fault](params, cls)
        self.solver = cls(self.scene, compat=compat, device=device, resort_every=resort_every,
                          params=params)
        self._lattice = inputs.lattice(cell.scene, cell.scene_path.parent)

    def start(self, s0: dict[str, np.ndarray]):
        """The program's bound start carry: ``tt.build_state`` of the
        scene, which has to equal the benchmark's own lattice on every
        row, body rows included, with S0's positions and tags in its live
        rows; with a dynamic body, also its ``init_rigid``."""
        st = self.tt.build_state(self.scene, device=self.device)
        n, ref = int(s0["num_active"]), self._lattice
        if st.num_active != n:
            raise ValueError(f"build_state made {st.num_active} live rows, the lattice {n}")
        for k in ("x", "v", "density", "pressure", "mass", "volume", "material", "color"):
            ours = getattr(st, k)[:n].cpu().numpy()
            if not np.array_equal(ours, ref[k]):
                rows = np.flatnonzero((ours != ref[k]).reshape(n, -1).any(-1))
                raise ValueError(f"build_state's {k} differs from the benchmark's lattice on "
                                 f"{rows.size} rows, the first {rows[:8].tolist()}")
        x, tags = st.x.clone(), st.object_id.clone()
        x[:n] = torch.from_numpy(s0["x"]).to(self.device)
        tags[:n] = torch.from_numpy(s0["object_id"]).to(self.device)
        bound = self.solver.bind(dataclasses.replace(st, x=x, object_id=tags))
        return (bound, self.solver.init_rigid(bound)) if self.rigid else bound

    def advance(self, carry, steps: int):
        if self.rigid:
            return self.tt.advance(self.solver, carry[0], carry[1], steps)[:2]
        return self.tt.advance(self.solver, carry, None, steps)[0]

    def dump(self, carry) -> dict[str, np.ndarray]:
        """The live rows as host arrays (``state_to_host``), with the
        bodies' state (``rigid_to_host``, each field named ``rigid_<f>``)."""
        if self.rigid:
            return self.tt.state_to_host(carry[0]) | _rigid_host(self.tt, carry[1])
        return self.tt.state_to_host(carry)

    def to_host(self, carry) -> dict[str, np.ndarray]:
        """Every row of the carry's state, as :func:`to_host`, with the
        bodies' state as :meth:`dump` names it."""
        if self.rigid:
            return to_host(carry[0]) | _rigid_host(self.tt, carry[1])
        return to_host(carry)

    def rows(self, carry) -> dict[str, torch.Tensor]:
        """``x`` and ``material`` of every row of a carry, or of a dump."""
        st = carry if isinstance(carry, dict) else carry[0] if self.rigid else carry
        if isinstance(st, dict):
            return {"x": torch.as_tensor(st["x"]), "material": torch.as_tensor(st["material"])}
        return {"x": st.x, "material": st.material}

    def same(self, a, b) -> bool:
        """Whether two carries are bitwise equal in the replayed fields."""
        if self.rigid:
            return (all(torch.equal(getattr(a[0], f), getattr(b[0], f)) for f in REPLAYED)
                    and all(torch.equal(getattr(a[1], f), getattr(b[1], f))
                            for f in RIGID_REPLAYED))
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in REPLAYED)

    def health(self, carry) -> int:
        """The state's ``nan_count`` (one read of the device)."""
        return int(self.solver.metrics(carry[0] if self.rigid else carry)["nan_count"])

    def synchronize(self) -> None:
        self.solver.synchronize()


def _rigid_host(tt, rigid) -> dict[str, np.ndarray]:
    return {f"rigid_{k}": a for k, a in tt.rigid_to_host(rigid).items()}


def to_host(state) -> dict[str, np.ndarray]:
    """Every row of a device state, as host arrays, with ``num_active``."""
    out = {f.name: getattr(state, f.name).cpu().numpy() for f in dataclasses.fields(state)
           if isinstance(getattr(state, f.name), torch.Tensor)}
    return out | {"num_active": np.asarray(state.num_active)}
