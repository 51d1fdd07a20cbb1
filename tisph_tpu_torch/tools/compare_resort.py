"""Position divergence of the amortized rebuild (R substeps per neighbour
structure) from the per-substep rebuild (R = 1), ``tools/
compare_resort.py``'s measurement.

    python -m tisph_tpu_torch.tools.compare_resort [scene.json] [--resort 3]
        [--steps 200] [--json] [--cpu]

Prints the position RMSE, and its max and 99th percentile, in units of
the support length h over the fluid particles, each followed by its
``object_id`` through the sorts: the number that grounds (or forbids) R > 1
for the headline rate.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from tisph_tpu_torch.config import SceneConfig, load_scene
from tisph_tpu_torch.geometry.builder import build_state
from tisph_tpu_torch.models.wcsph import WCSPH
from tisph_tpu_torch.tools import tool_device


def roll(scene: SceneConfig, resort_every: int, steps: int, device,
         chunk: int = 100) -> tuple[np.ndarray, np.ndarray]:
    """``steps`` substeps at R = ``resort_every`` in rollouts of ``chunk``
    (``run``), every particle's ``object_id`` set to its start row; returns
    x and material by that row."""
    solver = WCSPH(scene, device=device, resort_every=resort_every)
    state = solver.bind(build_state(scene, device=device))
    state = dataclasses.replace(
        state, object_id=torch.arange(state.capacity, dtype=torch.int32, device=device))
    state = solver.run(state, steps, check_every=chunk)
    inv = torch.argsort(state.object_id)
    return state.x[inv].cpu().numpy(), state.material[inv].cpu().numpy()


def compare(scene_path: str, resort: int, steps: int, device) -> dict:
    """The record of R = ``resort`` against R = 1 after ``steps`` substeps."""
    scene = load_scene(scene_path)
    x1, m1 = roll(scene, 1, steps, device)
    xr, _ = roll(scene, resort, steps, device)
    act = m1 == 1
    d = np.linalg.norm(x1[act] - xr[act], axis=-1)
    h = scene.support_length
    rmse = float(np.sqrt((d ** 2).mean()))
    return {
        "scene": scene_path, "steps": steps, "resort_every": resort, "h": h,
        "rmse": rmse,
        "rmse_over_h": rmse / h,
        "max_over_h": float(d.max() / h),
        "p99_over_h": float(np.percentile(d, 99) / h),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="scenes/demo_3d.json")
    ap.add_argument("--resort", type=int, default=3)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out = compare(args.scene, args.resort, args.steps, tool_device(args.cpu))
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
