"""Programmatic API demo, no scene file: ``examples/demo.py`` on the port.
A 2D dam break built in code (two fluid blocks in a 3 x 2 domain), run by
WCSPH and drawn by the viewer, one PNG per frame with ``--out``.

Usage: python -m tisph_tpu_torch.demo [--frames 60] [--substeps 5]
       [--out DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import tisph_tpu_torch as tt
from tisph_tpu_torch.config import FluidBlock, SceneConfig
from tisph_tpu_torch.render.viewer import Viewer


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="2D dam break built in code")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--substeps", type=int, default=5)
    ap.add_argument("--out", default=None, help="write demo_NNNNN.png here (headless)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene = SceneConfig(
        dim=2,
        domain_start=(0.0, 0.0),
        domain_end=(3.0, 2.0),
        particle_radius=0.01,
        gravitation=(0.0, -9.81),
        c_s=60.0,
        fluid_blocks=(
            FluidBlock(start=(0.2, 0.1), end=(0.8, 1.2), velocity=(0.0, -2.0)),
            FluidBlock(start=(2.2, 0.1), end=(2.8, 0.7), velocity=(-1.0, 0.0),
                       color=(0.9, 0.4, 0.2)),
        ),
    )
    solver = tt.WCSPH(scene, device=args.device)
    state = solver.bind(tt.build_state(scene, device=args.device))
    print(f"{state.num_active} particles on {args.device}")

    viewer = Viewer(scene, interactive=args.out is None)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for frame in range(args.frames):
        state = solver.rollout(state, args.substeps)
        viewer.show(state, title=f"frame {frame}")
        if args.out:
            viewer.savefig(os.path.join(args.out, f"demo_{frame:05d}.png"))
    viewer.close()
    nan = solver.metrics(state)["nan_count"]
    print("done" if not nan else f"ERROR: {nan} non-finite values")
    return 1 if nan else 0


if __name__ == "__main__":
    raise SystemExit(main())
