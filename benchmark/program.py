"""The system under test, ``tisph_tpu_torch``, as a cell drives it: the
solver a configuration names, its start state, ``advance``, the dump and
the health read.  The only module of the benchmark that imports it."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import inputs


# faults planted in the program's physics, for the readings the check's
# limits are set from (``benchmark.control --fault``); a run plants none
FAULTS = {
    "viscosity_dropped": lambda p: dataclasses.replace(p, viscosity=0.0),
    "pressure_scaled": lambda p: dataclasses.replace(p, stiffness=0.9 * p.stiffness),
    # Akinci's boundary viscosity left out: no change without boundary rows
    "boundary_viscosity_dropped": lambda p: dataclasses.replace(p, boundary_sigma=0.0),
}


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
        kw = {"compat": compat, "device": device, "resort_every": resort_every}
        if fault is not None:
            kw["params"] = FAULTS[fault](tt.SolverParams.from_scene(self.scene, compat))
        if kind == "wcsph":
            self.solver = tt.WCSPH(self.scene, **kw)
            if any(rb.is_dynamic for rb in self.scene.rigid_bodies):
                raise ValueError("the wcsph path of the benchmark has no dynamic bodies")
        elif kind == "legacy":
            self.solver = tt.WCSPHLegacy(self.scene, **kw)
        else:
            raise ValueError(f"unknown solver {kind!r}")
        self._lattice = inputs.lattice(cell.scene)

    def start(self, s0: dict[str, np.ndarray]):
        """The program's bound start state: ``tt.build_state`` of the
        scene, which has to equal the benchmark's own lattice, with S0's
        positions and tags in its live rows."""
        st = self.tt.build_state(self.scene, device=self.device)
        n, ref = int(s0["num_active"]), self._lattice
        if st.num_active != n:
            raise ValueError(f"build_state made {st.num_active} live rows, the lattice {n}")
        for k in ("x", "v", "density", "pressure", "mass", "volume", "material", "color"):
            if not np.array_equal(getattr(st, k)[:n].cpu().numpy(), ref[k]):
                raise ValueError(f"build_state's {k} differs from the benchmark's lattice")
        x, tags = st.x.clone(), st.object_id.clone()
        x[:n] = torch.from_numpy(s0["x"]).to(self.device)
        tags[:n] = torch.from_numpy(s0["object_id"]).to(self.device)
        return self.solver.bind(dataclasses.replace(st, x=x, object_id=tags))

    def advance(self, state, steps: int):
        return self.tt.advance(self.solver, state, None, steps)[0]

    def dump(self, state) -> dict[str, np.ndarray]:
        return self.tt.state_to_host(state)

    def health(self, state) -> int:
        """The state's ``nan_count`` (one read of the device)."""
        return int(self.solver.metrics(state)["nan_count"])

    def synchronize(self) -> None:
        self.solver.synchronize()


def to_host(state) -> dict[str, np.ndarray]:
    """Every row of a device state, as host arrays, with ``num_active``."""
    out = {f.name: getattr(state, f.name).cpu().numpy() for f in dataclasses.fields(state)
           if isinstance(getattr(state, f.name), torch.Tensor)}
    return out | {"num_active": np.asarray(state.num_active)}
