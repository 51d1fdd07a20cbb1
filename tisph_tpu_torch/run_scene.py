"""Run a scene file: the main loop of ``examples/run_scene.py`` on the
PyTorch port (no viewer, orbit, BPA, GIF or checkpoint options).  A scene
with a dynamic rigid body (``"isDynamic": true``) runs the coupled solver
``WCSPHRigid``; static bodies are boundary particles of plain ``WCSPH``
(``make_solver``).

Usage:
    python -m tisph_tpu_torch.run_scene scenes/demo_3d.json --steps 100 \
        --substeps 5 --resort 2 --metrics-every 10 [--out DIR --format npz|png] \
        [--compat reference|config|reference-exact] [--device cuda] \
        [--layout seg|linear]

``--layout linear`` runs the linear layout's sweeps, at ``--resort 1`` only.
``--compat`` is the reference's: ``reference-exact`` replays its shipped
V2 density bug (zero pressure), ``config`` honours the scene keys it
ignores.

``--out`` writes one frame per rendered frame through
``render.export.FrameExporter``: ``frame_NNNNNN.npz`` with the reference's
keys (``position``, ``velocity``, ``density``, ``pressure``, ``material``,
``color``, live particles only) or ``frame_NNNNNN.png``.  Exits 1 when a
metrics frame or the final state holds a non-finite position or velocity.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

import tisph_tpu_torch as tt
from tisph_tpu_torch.render.export import FrameExporter


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run a scene on the PyTorch port")
    ap.add_argument("scene", help="scene JSON (reference schema)")
    ap.add_argument("--steps", type=int, default=100, help="frames")
    ap.add_argument("--substeps", type=int, default=5, help="solver steps per frame")
    ap.add_argument("--resort", type=int, default=1,
                    help="substeps per neighbour-structure rebuild (R; 1 = "
                         "the reference's per-substep cadence)")
    ap.add_argument("--metrics-every", type=int, default=10)
    ap.add_argument("--compat", choices=("reference", "config", "reference-exact"),
                    default="reference",
                    help="'reference': the intended equations with the reference's "
                         "constants; 'config': honour the scene keys the reference "
                         "ignores; 'reference-exact': replay its shipped V2 bug "
                         "(zero pressure)")
    ap.add_argument("--out", default=None, help="frame output directory")
    ap.add_argument("--format", choices=("npz", "png"), default="npz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layout", choices=("seg", "linear"), default="seg",
                    help="the sweeps' layout (linear: --resort 1 only)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    scene = tt.load_scene(args.scene)
    print(f"scene: dim={scene.dim} domain={scene.domain_start}->{scene.domain_end} "
          f"r={scene.particle_radius}")
    solver, state, rigid = tt.make_solver(scene, tt.build_state(scene, device=device),
                                          device=device, resort_every=args.resort,
                                          layout=args.layout, compat=args.compat)
    if rigid is not None:
        print(f"dynamic rigid bodies: {rigid.num_bodies}")
    print(f"particles: {state.num_active} (capacity {state.capacity}) "
          f"grid: res={solver.spec.res} dt={solver.params.dt} R={args.resort} "
          f"layout={args.layout} compat={args.compat} device={device}")
    exporter = FrameExporter(args.out, fmt=args.format, scene=scene) if args.out else None

    _sync(device)
    t0 = time.perf_counter()
    try:
        for frame in range(args.steps):
            state, rigid = tt.advance(solver, state, rigid, args.substeps)
            if exporter is not None:
                exporter.save(state, frame)
            if args.metrics_every and frame % args.metrics_every == 0:
                m = solver.metrics(state)
                print(f"frame {frame:5d}  vmax={m['max_velocity']:8.3f}  "
                      f"cfl={m['cfl']:6.4f}  rho_err={m['avg_density_error']:7.4f}  "
                      f"nan={m['nan_count']}")
                if m["nan_count"]:
                    print("ERROR: NaN detected, aborting", file=sys.stderr)
                    return 1
    finally:
        if exporter is not None:
            exporter.close()
    _sync(device)
    wall = time.perf_counter() - t0
    if solver.metrics(state)["nan_count"]:
        print("ERROR: NaN in the final state", file=sys.stderr)
        return 1
    total = args.steps * args.substeps
    print(f"done: {total} steps, {wall:.2f}s wall (frame output included), "
          f"{state.num_active * total / wall:.3e} particle-steps/sec on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
