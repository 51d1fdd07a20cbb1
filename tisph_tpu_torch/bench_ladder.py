"""The measurement ladder of the root ``bench_ladder.py`` on the port: the
same six cells (scenes, steps and options), on one GPU.

Each cell builds its scene on the card, binds the solver at R=2 (the seg
layout's headline cadence), runs one warm-up rollout of the cell's length
and then times one more between ``torch.cuda.synchronize()`` calls.  It
prints one JSON line per cell with the root ladder's keys (``sweep`` is
``"cuda"``) and ``device``, the card's name and power limit.  The emitter
cell times ``rollout_emit``, the rigid cell ``rollout_coupled``; the 1M
cell times the copy of the final state to the host (``export_s``) and ball
pivoting on its xy projection (``bpa_s``, with ``bpa_loops``), as the root
ladder does.

Usage: python -m tisph_tpu_torch.bench_ladder [substring] [--out PATH]

It needs a CUDA device, and writes a file only with ``--out`` (never the
root's ``BENCH_LADDER.json``, which holds the TPU rounds' results).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

import tisph_tpu_torch as tt
from tisph_tpu_torch.render.bpa2d import extract_boundary_2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LADDER = [
    ("2d_5k", "scenes/bench_2d_5k.json", 100, {}),
    ("2d_obstacle", "scenes/bench_2d_obstacle.json", 100, {}),
    ("3d_100k", "scenes/bench_3d_100k.json", 50, {}),
    ("3d_mesh_emitter_500k", "scenes/bench_3d_mesh_500k.json", 30, {"emit": True}),
    ("3d_1m_bpa", "scenes/bench_3d_1m.json", 30, {"bpa": True, "export": True}),
    ("3d_rigid_coupled", "scenes/bench_3d_rigid.json", 30, {"rigid": True}),
]
RESORT = 2


def device_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_config(name: str, scene_path: str, steps: int, opts: dict, device: str) -> dict:
    scene = tt.load_scene(os.path.join(ROOT, scene_path))
    solver, state, rigid = tt.make_solver(scene, tt.build_state(scene, device="cuda"),
                                          device="cuda", resort_every=RESORT)
    if bool(opts.get("rigid")) != (rigid is not None):
        raise ValueError(f"{name}: the scene's dynamic bodies disagree with the cell")
    ems = None
    if opts.get("emit"):
        ems = [tt.make_emitter_state(em, scene, "cuda") for em in scene.emitters]
    n = state.num_active

    state, rigid, ems = tt.advance(solver, state, rigid, steps, ems)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rigid, ems = tt.advance(solver, state, rigid, steps, ems)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    extra = {}
    if opts.get("export"):
        t1 = time.perf_counter()
        tt.state_to_host(state)
        extra["export_s"] = round(time.perf_counter() - t1, 3)
    if opts.get("bpa"):
        t1 = time.perf_counter()
        host = tt.state_to_host(state)
        pts = host["x"][host["material"] == 1][:, :2]  # xy projection boundary
        b = extract_boundary_2d(pts, radius=3.0 * scene.particle_radius)
        extra["bpa_s"] = round(time.perf_counter() - t1, 3)
        extra["bpa_loops"] = len(b.loops)

    res = {
        "config": name,
        "particles": state.num_active,
        "steps": steps,
        "wall_s": round(wall, 3),
        "particle_steps_per_sec": round(n * steps / wall, 1),
        "nan": solver.metrics(state)["nan_count"],
        "sweep": "cuda",
    }
    if rigid is not None:
        res["layout"] = solver.layout
    return res | {"resort": RESORT, **extra, "device": device}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("only", nargs="?", default=None, help="run the cells whose name holds this")
    ap.add_argument("--out", default=None, help="also write the results here as a JSON list")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ladder: no CUDA device; the port is measured on a GPU only",
              file=sys.stderr)
        return 2
    if args.out and os.path.abspath(args.out) == os.path.join(ROOT, "BENCH_LADDER.json"):
        print("bench_ladder: BENCH_LADDER.json holds the TPU rounds' results", file=sys.stderr)
        return 2
    device = device_line()
    results = []
    for name, path, steps, opts in LADDER:
        if args.only and args.only not in name:
            continue
        res = run_config(name, path, steps, opts, device)
        print(json.dumps(res), flush=True)
        results.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0 if all(r["nan"] == 0 for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
