"""Run a scene on a sharded solver: ``examples/run_sharded.py`` on the
port, the 1-D slab decomposition or, with ``--mesh2d``, the rectangle
(or box) decomposition.

Usage:
    python -m tisph_tpu_torch.run_sharded scenes/demo_3d.json --devices 2
    python -m tisph_tpu_torch.run_sharded scenes/demo_3d.json \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --steps 50 --resort 2
    python -m tisph_tpu_torch.run_sharded scenes/demo_3d.json --mesh2d 2x2 \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --resort 2
    python -m tisph_tpu_torch.run_sharded <small scene> --devices cpu,cpu,cpu,cpu

``--devices N`` puts shard s on ``cuda:s`` and fails without N CUDA
devices (no fallback to the CPU); a comma list places the shards as
written (row-major over the ``--mesh2d`` shape, whose product its length
must be), repeats allowed.  Shards that share a device run the
exchanges on it and measure their cost, not any scaling: the run says
so.  ``--layout linear`` runs the slab solver's density and force sweeps
on the linear layout (kernel C, ``--resort 1`` only).  A scene with
emitters runs ``rollout_emit``, one with a dynamic rigid body
``rollout_coupled`` (``advance``, as ``run_scene``).  ``--profile N``
then prints ``bench.py``'s profile of N more steps (device busy, the
profiled wall, device operations per step) as one JSON line.  Exits 1 on a
non-finite position or velocity.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import tisph_tpu_torch as tt
from tisph_tpu_torch import bench
from tisph_tpu_torch.parallel import (
    ShardedWCSPH,
    ShardedWCSPHRect,
    make_mesh,
    make_mesh2d,
    make_mesh3d,
)


def _mesh(spec: str | None, shape: tuple[int, ...] | None = None):
    """The mesh of ``--devices`` (and the ``--mesh2d`` shape)."""
    n = None if spec is None or not spec.isdigit() else int(spec)
    devices = None if spec is None or spec.isdigit() else [
        d.strip() for d in spec.split(",") if d.strip()]
    if shape is None:
        return make_mesh(n, devices)
    if n is not None and n != int(np.prod(shape)):
        raise SystemExit(f"--devices {n} for a {'x'.join(map(str, shape))} mesh")
    return (make_mesh2d if len(shape) == 2 else make_mesh3d)(*shape, devices=devices)


def _shape(arg: str) -> tuple[int, ...]:
    try:
        sizes = tuple(int(v) for v in arg.lower().split("x"))
    except ValueError:
        sizes = ()
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise SystemExit(f"--mesh2d expects SXxSY or SXxSYxSZ (e.g. 2x2 or 2x2x2), got {arg!r}")
    return sizes


def _sync(mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run a scene on a sharded solver")
    ap.add_argument("scene")
    ap.add_argument("--devices", default=None,
                    help="N (the first N CUDA devices) or a comma list, e.g. "
                         "cuda:0,cuda:0 or cpu,cpu,cpu,cpu; default every CUDA device "
                         "(the mesh's product of them with --mesh2d)")
    ap.add_argument("--mesh2d", default=None, metavar="SXxSY[xSZ]",
                    help="the rectangle decomposition (ShardedWCSPHRect) on an SXxSY mesh, "
                         "or the box decomposition on an SXxSYxSZ one")
    ap.add_argument("--layout", choices=("seg", "linear"), default="seg",
                    help="the slab solver's density and force sweeps: seg (kernel A) or "
                         "linear (kernel C, --resort 1)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--resort", type=int, default=1,
                    help="substeps per rebuild (R)")
    ap.add_argument("--profile", type=int, default=0,
                    help="then torch.profiler over N more steps (bench.py's --profile): "
                         "one JSON line")
    args = ap.parse_args(argv)
    if args.mesh2d and args.layout != "seg":
        raise SystemExit("--mesh2d runs the seg layout only")

    mesh = _mesh(args.devices, _shape(args.mesh2d) if args.mesh2d else None)
    names = [str(d) for d in mesh.devices]
    print(f"mesh: {'x'.join(map(str, mesh.shape))} shards on {names}")
    if len(set(mesh.devices)) < mesh.size:
        print("note: shards share a device, so this run measures the exchanges' cost "
              "there, not multi-device scaling")
    scene = tt.load_scene(args.scene)
    if args.mesh2d:
        solver = ShardedWCSPHRect(scene, mesh, resort_every=args.resort)
    else:
        solver = ShardedWCSPH(scene, mesh, resort_every=args.resort, layout=args.layout)
    shards = solver.bind(tt.build_state(scene, device=mesh.devices[0]))
    n = sum(st.num_active for st in shards)
    if args.mesh2d:
        print(f"particles: {n}, shard={solver.shard_rows} rows, halo caps {solver.cap_h} rows, "
              f"migration caps {solver.cap_m} rows")
    else:
        print(f"particles: {n}, halo={solver.halo} rows ({solver.halo_path}), "
              f"shard={solver.shard_rows} rows, resort={solver.resort} edge={solver.resort_edge}, "
              f"layout={solver.layout}")

    ems = [tt.make_emitter_state(e, scene, mesh.devices[0]) for e in scene.emitters] or None
    rigid = None
    if any(rb.is_dynamic for rb in scene.rigid_bodies):
        rigid = solver.init_rigid(shards)
        print(f"dynamic rigid bodies: {rigid.num_bodies}")
    # warm-up (kernel build and first launches), discarded: rollouts change
    # none of their inputs
    tt.advance(solver, shards, rigid, args.resort, ems)
    _sync(mesh)
    solver.reset_flags()
    t0 = time.perf_counter()
    shards, _, _ = tt.advance(solver, shards, rigid, args.steps, ems)
    _sync(mesh)
    wall = time.perf_counter() - t0
    n = sum(st.num_active for st in shards)
    m = solver.metrics(shards)
    if args.mesh2d:
        flags = (f"halo_flag={m['occ_halo']} migrate_anomalies={m['migrate_anomalies']} "
                 f"shard_rows_used={m['shard_rows_used']}/{m['shard_rows']} "
                 f"dropped_rows={m['dropped_rows']}")
    else:
        flags = f"halo_flag={m['occ_halo']} resort_fallbacks={m['resort_fallbacks']}"
    print(f"{args.steps} steps in {wall:.2f}s -> {n * args.steps / wall:.3e} particle-steps/sec; "
          f"vmax={m['max_velocity']:.3f} cfl={m['cfl']:.4f} nan={m['nan_count']} {flags}")
    if m["nan_count"]:
        print("ERROR: NaN detected", file=sys.stderr)
        return 1
    if args.profile:
        if mesh.devices[0].type != "cuda":
            raise SystemExit("--profile measures a CUDA device")
        prof = bench.profile_steps(solver, shards, rigid, ems, args.profile, args.resort)
        print(json.dumps(prof))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
