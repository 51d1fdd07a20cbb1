"""A long run of one scene through ``WCSPH.run``, the path a user's long
simulation takes, and its end state (``tools/soak.py``'s record).

    python -m tisph_tpu_torch.tools.soak [scene.json] [--steps 10000]
        [--resort 2] [--chunk 400] [--out PATH] [--cpu]

Prints each chunk's particle-steps/s (``run(..., verbose=True)``), then one
JSON record with the JAX tool's keys: ``regrow_events`` is always ``[]``
(the port's sweeps have no window or row-pad cap to regrow), ``metrics``
is ``WCSPH.metrics`` of the end state and ``device`` the card's name.
Exits 1 when the end state holds a non-finite position or velocity.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tisph_tpu_torch.config import load_scene
from tisph_tpu_torch.geometry.builder import build_state
from tisph_tpu_torch.models.wcsph import WCSPH
from tisph_tpu_torch.tools import tool_device


def soak(scene_path: str, steps: int, resort: int, chunk: int, device):
    """``steps`` substeps of ``scene_path`` at R = ``resort`` through
    ``run(check_every=chunk, verbose=True)``; returns the record, the
    solver and the end state."""
    scene = load_scene(scene_path)
    solver = WCSPH(scene, device=device, resort_every=resort)
    state = solver.bind(build_state(scene, device=device))
    n = state.num_active
    solver.synchronize()
    t0 = time.perf_counter()
    state = solver.run(state, steps, check_every=chunk, verbose=True)
    solver.synchronize()
    wall = time.perf_counter() - t0
    rec = {
        "scene": scene_path,
        "particles": n,
        "steps": steps,
        "resort_every": resort,
        "wall_s": wall,
        "pps_wall": n * steps / wall,
        "sim_seconds": steps * float(solver.params.dt),
        "regrow_events": [],
        "metrics": solver.metrics(state),
        "device": (torch.cuda.get_device_name(solver.device)
                   if solver.device.type == "cuda" else "cpu"),
    }
    return rec, solver, state


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="scenes/demo_3d.json")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--resort", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--chunk", type=int, default=400, help="steps per chunk of run()")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    rec, _, _ = soak(args.scene, args.steps, args.resort, args.chunk, tool_device(args.cpu))
    print(json.dumps(rec, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    return 0 if rec["metrics"]["nan_count"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
