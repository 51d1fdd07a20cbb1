"""Divergence of the reference's shipped behaviour from the intended
equations: position RMSE between ``compat="reference"`` and
``compat="reference-exact"`` (the V2 density overwritten with the self
term, so pressure is 0; the V1 domain clamp never called), snapshot by
snapshot, ``tools/compare_compat.py``'s measurement.

    python -m tisph_tpu_torch.tools.compare_compat [scene.json]
        [--solver wcsph|legacy] [--frames 20] [--substeps 5] [--json] [--cpu]

Every particle's ``object_id`` is set to its start row and each snapshot
is put back in that order, so a row is one particle in both runs.  The
table backs README's fidelity section.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from tisph_tpu_torch.config import load_scene
from tisph_tpu_torch.geometry.builder import build_state
from tisph_tpu_torch.models.state import SimState
from tisph_tpu_torch.models.wcsph import WCSPH
from tisph_tpu_torch.models.wcsph_legacy import WCSPHLegacy
from tisph_tpu_torch.tools import tool_device


def run(scene_path: str, compat: str, solver_name: str, frames: int, substeps: int,
        device) -> tuple[torch.Tensor, SimState]:
    """``frames`` rollouts of ``substeps``: the (frames, capacity, dim)
    positions by start row, and the end state's x and material in that
    order."""
    scene = load_scene(scene_path)
    cls = WCSPH if solver_name == "wcsph" else WCSPHLegacy
    solver = cls(scene, compat=compat, device=device)
    state = solver.bind(build_state(scene, device=device))
    state = dataclasses.replace(
        state, object_id=torch.arange(state.capacity, dtype=torch.int32, device=device))
    snaps = []
    for _ in range(frames):
        state = solver.rollout(state, substeps)
        inv = torch.argsort(state.object_id)
        snaps.append(state.x[inv])
    return torch.stack(snaps), dataclasses.replace(state, x=state.x[inv],
                                                   material=state.material[inv])


def compare(scene_path: str, solver_name: str, frames: int, substeps: int, device) -> dict:
    """The record of both modes: the RMSE over the intended run's end-state
    fluid rows at every snapshot."""
    xs_int, st_int = run(scene_path, "reference", solver_name, frames, substeps, device)
    xs_ref, _ = run(scene_path, "reference-exact", solver_name, frames, substeps, device)
    active = st_int.fluid_mask
    diff2 = torch.sum((xs_int - xs_ref) ** 2, dim=-1)  # (frames, capacity)
    nact = torch.clamp(active.sum(), min=1)
    rmse = torch.sqrt(torch.where(active[None], diff2, 0.0).sum(dim=1) / nact).tolist()
    h = load_scene(scene_path).support_length
    rows = [{"step": (i + 1) * substeps, "rmse": r, "rmse_over_h": r / h}
            for i, r in enumerate(rmse)]
    return {"scene": scene_path, "solver": solver_name, "h": h,
            "rmse_final": rows[-1]["rmse"], "rows": rows}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="scenes/demo_2d.json")
    ap.add_argument("--solver", choices=["wcsph", "legacy"], default="wcsph")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--substeps", type=int, default=5)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out = compare(args.scene, args.solver, args.frames, args.substeps, tool_device(args.cpu))
    if args.json:
        print(json.dumps(out))
    else:
        print(f"{args.scene} [{args.solver}]  intended vs reference-exact")
        print(f"{'step':>6}  {'pos RMSE':>12}  {'RMSE / h':>10}")
        for row in out["rows"]:
            print(f"{row['step']:6d}  {row['rmse']:12.6f}  {row['rmse_over_h']:10.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
