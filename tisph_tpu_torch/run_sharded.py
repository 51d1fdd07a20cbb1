"""Run a scene on the 1-D sharded solver: ``examples/run_sharded.py``'s
1-D path on the port.

Usage:
    python -m tisph_tpu_torch.run_sharded scenes/demo_3d.json --devices 2
    python -m tisph_tpu_torch.run_sharded scenes/demo_3d.json \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 --steps 50 --resort 2
    python -m tisph_tpu_torch.run_sharded <small scene> --devices cpu,cpu,cpu,cpu

``--devices N`` puts shard s on ``cuda:s`` and fails without N CUDA
devices (no fallback to the CPU); a comma list places the shards as
written, repeats allowed.  Shards that share a device run the halo
exchange on it and measure its cost, not any scaling: the run says so.
A scene with emitters runs ``rollout_emit`` (the global tail pool), one
with a dynamic rigid body ``rollout_coupled`` (``advance``, as
``run_scene``).  ``--profile N`` then prints ``bench.py``'s profile of N
more steps (device busy, idle share, device operations per step) as one
JSON line.  ``--mesh2d`` (the rectangle decomposition) is not ported
yet.  Exits 1 on a non-finite position or velocity.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import tisph_tpu_torch as tt
from tisph_tpu_torch import bench
from tisph_tpu_torch.parallel import ShardedWCSPH, make_mesh


def _mesh(spec: str | None):
    if spec is None:
        return make_mesh()
    if spec.isdigit():
        return make_mesh(int(spec))
    return make_mesh(devices=[d.strip() for d in spec.split(",") if d.strip()])


def _sync(mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run a scene on the 1-D sharded solver")
    ap.add_argument("scene")
    ap.add_argument("--devices", default=None,
                    help="N (the first N CUDA devices) or a comma list, e.g. "
                         "cuda:0,cuda:0 or cpu,cpu,cpu,cpu; default every CUDA device")
    ap.add_argument("--mesh2d", default=None, metavar="SXxSY[xSZ]",
                    help="the rectangle decomposition (not ported yet)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--resort", type=int, default=1,
                    help="substeps per rebuild (R)")
    ap.add_argument("--profile", type=int, default=0,
                    help="then torch.profiler over N more steps (bench.py's --profile): "
                         "one JSON line")
    args = ap.parse_args(argv)
    if args.mesh2d:
        raise NotImplementedError(
            "--mesh2d: the rectangle decomposition (tisph_tpu/parallel/domain2d.py, "
            "ShardedWCSPHRect) is not ported yet; it is ROADMAP.md queue 1 item 6's "
            "next slice")

    mesh = _mesh(args.devices)
    names = [str(d) for d in mesh.devices]
    print(f"mesh: {mesh.size} shards on {names}")
    if len(set(mesh.devices)) < mesh.size:
        print("note: shards share a device, so this run measures the halo exchange's cost "
              "there, not multi-device scaling")
    scene = tt.load_scene(args.scene)
    solver = ShardedWCSPH(scene, mesh, resort_every=args.resort)
    shards = solver.bind(tt.build_state(scene, device=mesh.devices[0]))
    n = sum(st.num_active for st in shards)
    print(f"particles: {n}, halo={solver.halo} rows ({solver.halo_path}), "
          f"shard={solver.shard_rows} rows, resort={solver.resort} edge={solver.resort_edge}")

    ems = [tt.make_emitter_state(e, scene, mesh.devices[0]) for e in scene.emitters] or None
    rigid = None
    if any(rb.is_dynamic for rb in scene.rigid_bodies):
        rigid = solver.init_rigid(shards)
        print(f"dynamic rigid bodies: {rigid.num_bodies}")
    # warm-up (kernel build and first launches), discarded: rollouts change
    # none of their inputs
    tt.advance(solver, shards, rigid, args.resort, ems)
    _sync(mesh)
    solver.occ_resort = 0
    t0 = time.perf_counter()
    shards, _, _ = tt.advance(solver, shards, rigid, args.steps, ems)
    _sync(mesh)
    wall = time.perf_counter() - t0
    n = sum(st.num_active for st in shards)
    m = solver.metrics(shards)
    print(f"{args.steps} steps in {wall:.2f}s -> {n * args.steps / wall:.3e} particle-steps/sec; "
          f"vmax={m['max_velocity']:.3f} cfl={m['cfl']:.4f} nan={m['nan_count']} "
          f"halo_flag={m['occ_halo']} resort_fallbacks={m['resort_fallbacks']}")
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
