"""Run a scene file: the main loop of ``examples/run_scene.py`` on the
PyTorch port, its viewer, orbit and GIF options included.  A scene with a dynamic
rigid body (``"isDynamic": true``) runs the coupled solver ``WCSPHRigid``;
static bodies are boundary particles of plain ``WCSPH`` (``make_solver``);
a scene with emitters runs ``rollout_emit`` (``make_solver`` refuses one
with a dynamic body too).

Usage:
    python -m tisph_tpu_torch.run_scene scenes/demo_3d.json --steps 100 \
        --substeps 5 --resort 2 --metrics-every 10 [--out DIR --format npz|png] \
        [--compat reference|config|reference-exact] [--device cuda] \
        [--layout seg|linear] [--solver wcsph|legacy] \
        [--checkpoint PATH] [--resume PATH] [--bpa] \
        [--view] [--orbit] [--view-every N] [--gif OUT.gif]

``--solver legacy`` runs the reference's V1 physics (``WCSPHLegacy``, at
``--resort 1`` only).  ``--checkpoint`` writes the final state, the rigid
bodies and the emitters to an npz that either package loads; ``--resume``
starts from such a file, its emitter states in place of fresh ones.
``--bpa`` (2D scenes) runs ball pivoting on the final frame's fluid and
writes ``boundary.bpa.npz`` into ``--out`` (or the current directory).

``--layout linear`` runs the linear layout's sweeps, at ``--resort 1`` only.
``--compat`` is the reference's: ``reference-exact`` replays its shipped
V2 density bug (zero pressure), ``config`` honours the scene keys it
ignores.

``--view`` shows the particles in a matplotlib window (``render.viewer``;
headless Agg without a display), ``--orbit`` in the orbit-camera viewer
of 3D scenes (``render.orbit``: left-drag orbit, right-drag pan, scroll
dolly, wasd/qe move, r reset; a 2D scene falls back to ``--view``), both
redrawn every ``--view-every`` frames.  ``--gif`` assembles the PNG
frames of ``--out DIR --format png`` into a GIF (``render.video``).

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

import numpy as np
import torch

import tisph_tpu_torch as tt
from tisph_tpu_torch import checkpoint
from tisph_tpu_torch.render.bpa2d import extract_boundary_2d
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
    ap.add_argument("--solver", choices=("wcsph", "legacy"), default="wcsph",
                    help="legacy: the reference's V1 physics (--resort 1 only)")
    ap.add_argument("--checkpoint", default=None,
                    help="write a full-state checkpoint here at the end")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint written by --checkpoint")
    ap.add_argument("--bpa", action="store_true",
                    help="2D scenes: extract the fluid boundary with ball pivoting on the "
                         "final frame and save it as boundary.bpa.npz")
    ap.add_argument("--view", action="store_true",
                    help="live matplotlib window updated as frames complete (headless Agg "
                         "snapshots without a display)")
    ap.add_argument("--orbit", action="store_true",
                    help="3D scenes: the interactive orbit-camera viewer; implies --view")
    ap.add_argument("--view-every", type=int, default=1,
                    help="with --view or --orbit: redraw every N frames")
    ap.add_argument("--gif", default=None,
                    help="assemble the exported PNG frames into a GIF here (requires --out "
                         "DIR and --format png)")
    args = ap.parse_args(argv)
    if args.gif and (not args.out or args.format != "png"):
        ap.error("--gif requires --out DIR and --format png")

    device = torch.device(args.device)
    scene = tt.load_scene(args.scene)
    print(f"scene: dim={scene.dim} domain={scene.domain_start}->{scene.domain_end} "
          f"r={scene.particle_radius}")
    kw = dict(device=device, resort_every=args.resort, layout=args.layout, compat=args.compat)
    if args.solver == "legacy":
        solver = tt.WCSPHLegacy(scene, **kw)
        state, rigid = solver.bind(tt.build_state(scene, device=device)), None
    else:
        solver, state, rigid = tt.make_solver(scene, tt.build_state(scene, device=device), **kw)
    if rigid is not None:
        print(f"dynamic rigid bodies: {rigid.num_bodies}")
    emitters = None
    if scene.emitters:
        emitters = [tt.make_emitter_state(em, scene, device) for em in scene.emitters]
    if args.resume:
        state, rigid_ck, emitters_ck = checkpoint.load_npz(
            args.resume, with_rigid=True, with_emitters=True, device=device)
        if rigid_ck is not None:
            rigid = rigid_ck  # body momentum is not derivable from particles
        if emitters is not None and emitters_ck:
            emitters = emitters_ck  # the emission cadence goes on where it stopped
        print(f"resumed from {args.resume}: {state.num_active} particles"
              + (" + rigid body state" if rigid_ck is not None else "")
              + (f" + {len(emitters_ck)} emitter state(s)" if emitters_ck else ""))
    if emitters is not None:
        print(f"emitters: {len(emitters)} (batch sizes {[e.batch_size for e in emitters]})")
    print(f"particles: {state.num_active} (capacity {state.capacity}) "
          f"grid: res={solver.spec.res} dt={solver.params.dt} R={args.resort} "
          f"layout={args.layout} compat={args.compat} solver={args.solver} device={device}")
    exporter = FrameExporter(args.out, fmt=args.format, scene=scene) if args.out else None
    viewer = None
    if args.orbit and scene.dim == 3:
        from tisph_tpu_torch.render.orbit import OrbitViewer
        viewer = OrbitViewer(scene, interactive=True)
    elif args.view or args.orbit:
        if args.orbit:
            print("warning: --orbit is 3D-only; using the flat viewer", file=sys.stderr)
        from tisph_tpu_torch.render.viewer import Viewer
        viewer = Viewer(scene, interactive=True)

    _sync(device)
    t0 = time.perf_counter()
    try:
        for frame in range(args.steps):
            state, rigid, emitters = tt.advance(solver, state, rigid, args.substeps, emitters)
            if exporter is not None:
                exporter.save(state, frame)
            if viewer is not None and frame % args.view_every == 0:
                viewer.show(state, title=f"frame {frame}")
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
        if viewer is not None:
            viewer.close()
    _sync(device)
    wall = time.perf_counter() - t0
    if solver.metrics(state)["nan_count"]:
        print("ERROR: NaN in the final state", file=sys.stderr)
        return 1
    total = args.steps * args.substeps
    print(f"done: {total} steps, {wall:.2f}s wall (frame output included), "
          f"{state.num_active * total / wall:.3e} particle-steps/sec on {device}")
    if args.gif:
        from tisph_tpu_torch.render.video import frames_to_gif
        print(f"GIF written to {frames_to_gif(args.out, args.gif)}")
    if args.checkpoint:
        checkpoint.save_npz(state, args.checkpoint, rigid=rigid, emitters=emitters)
        print(f"checkpoint written to {args.checkpoint}")
    if args.bpa:
        host = tt.state_to_host(state)
        pts = host["x"][host["material"] == 1][:, :2]
        b = extract_boundary_2d(pts, radius=3.0 * scene.particle_radius)
        out = (args.out or ".") + "/boundary.bpa.npz"
        np.savez_compressed(
            out, points=b.points, edges=b.edges,
            loop_sizes=np.asarray([len(lp) for lp in b.loops]),
            loops=np.concatenate(b.loops) if b.loops else np.zeros(0, np.int64),
        )
        print(f"BPA boundary: {len(b.loops)} loops, {b.edges.shape[0]} edges -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
