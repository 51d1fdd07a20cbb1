"""Benchmark: particle-steps/sec of the port's WCSPH main path on one GPU.

Prints ONE JSON line shaped like the root ``bench.py``'s: ``metric``,
``value``, ``unit``, ``r1_pps`` and ``resort_every``, plus the card's
name.  Times warm rollouts only, between ``torch.cuda.synchronize()``
calls; R=2 is the headline cadence and R=1 (the reference's per-substep
resort) is always on record; the faster one is reported as ``value`` with
the cadence it ran at.  Both cadences start from the same bound state:
the dam break's early transient thins the fluid, so a cadence measured
after the other would see cheaper steps.  Needs a CUDA device: there is
no CPU measurement.

Usage: python -m tisph_tpu_torch.bench [--scene scenes/demo_3d.json] [--steps 50]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

import tisph_tpu_torch as tt

_SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scenes", "demo_3d.json")


def _measure(solver, state, steps: int, resort: int):
    """Warm rollout of ``steps`` at R = ``resort`` from ``state`` (which
    rollouts never modify); pps, or None on NaN."""
    solver.resort_every = resort
    state = solver.rollout(state, resort)  # warm-up: caches, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = solver.rollout(state, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if solver.metrics(state)["nan_count"]:
        return None
    return state.num_active * steps / wall


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=_SCENE)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the port is measured on a GPU only", file=sys.stderr)
        return 2

    scene = tt.load_scene(args.scene)
    state = tt.build_state(scene, device="cuda")
    solver = tt.WCSPH(scene, device="cuda")
    state = solver.bind(state)
    n = state.num_active

    pps = _measure(solver, state, args.steps, 2)
    if pps is None:
        print(json.dumps({"metric": "particle-steps/sec", "value": 0.0,
                          "unit": "particle-steps/sec", "error": "NaN during benchmark"}))
        return 1
    resort = 2
    r1_pps = _measure(solver, state, args.steps, 1)
    if r1_pps is not None and r1_pps > pps:
        pps, resort = r1_pps, 1
    print(json.dumps({
        "metric": f"particle-steps/sec ({scene.dim}D dam break, {n // 1000}k particles)",
        "value": round(pps, 1),
        "unit": "particle-steps/sec",
        "r1_pps": None if r1_pps is None else round(r1_pps, 1),
        "resort_every": resort,
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
