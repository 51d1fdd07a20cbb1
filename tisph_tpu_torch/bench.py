"""Benchmark: particle-steps/sec of the port's WCSPH main path on one GPU.

Prints ONE JSON line shaped like the root ``bench.py``'s: ``metric``,
``value``, ``unit``, ``r1_pps`` and ``resort_every``, plus the card's
name.  Times warm rollouts only, between ``torch.cuda.synchronize()``
calls; R=2 is the headline cadence and R=1 (the reference's per-substep
resort) is always on record; the faster one is reported as ``value`` with
the cadence it ran at.  Both cadences start from the same bound state:
the dam break's early transient thins the fluid, so a cadence measured
after the other would see cheaper steps.  A scene with a dynamic rigid
body times the coupled solver's ``rollout_coupled`` (``WCSPHRigid``), as
the ladder's ``3d_rigid_coupled`` cell does, and a scene with emitters
times ``rollout_emit``.  Needs a CUDA device: there is no CPU measurement.

``--solver legacy`` times the reference's V1 physics (``WCSPHLegacy``),
which rebuilds every step: R=1 only.  ``host_ms_per_step`` is the host's
time to queue the headline cadence's timed rollout, a step.

``--layout linear`` runs the linear layout's sweeps (``WCSPH(layout=
"linear")``), which rebuild every substep: it measures and reports R=1
only.  ``--settle N`` first runs N steps at R=2 (R=1 under ``linear``;
e.g. to put a falling body in the water) and measures from there.
``--profile N`` adds a ``profile`` entry per cadence: ``torch.profiler``
over N more warm steps, giving per step the profiled host wall, the
device busy time, the device operations (kernels, copies, fills) and the
costliest device operations by name.  ``graphs``
says whether the solver replayed each R-group as a CUDA graph (the
default on the card); the profiler sees the kernels inside a replay.

Usage: python -m tisph_tpu_torch.bench [--scene scenes/demo_3d.json] [--steps 50]
           [--layout {seg,linear}] [--solver {wcsph,legacy}]
       python -m tisph_tpu_torch.bench --scene scenes/bench_3d_rigid.json \
           [--settle 1200] [--profile 20]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

import tisph_tpu_torch as tt

_SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scenes", "demo_3d.json")


def _measure(solver, state, rigid, ems, steps: int, resort: int):
    """Warm rollout of ``steps`` at R = ``resort`` from ``state``,
    ``rigid`` and the emitters ``ems`` (None without dynamic bodies or
    emitters; rollouts modify none of them); (pps, or None on NaN, and the
    host's ms a step to queue the rollout)."""
    solver.resort_every = resort
    state, rigid, ems = tt.advance(solver, state, rigid, resort, ems)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rigid, ems = tt.advance(solver, state, rigid, steps, ems)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if solver.metrics(state)["nan_count"]:
        return None, host * 1e3 / steps
    return state.num_active * steps / wall, host * 1e3 / steps


def profile_steps(solver, state, rigid, ems, steps: int, resort: int, top: int = 8) -> dict:
    """``torch.profiler`` over ``steps`` warm steps at R = ``resort``, per
    step: device busy is the sum of the device operations' durations (one
    stream, so they do not overlap), and the profiled wall.  No idle share:
    the profiled wall holds the profiler's own host cost; the benchmark's
    ``device_idle_share`` takes busy against an unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    solver.resort_every = resort
    state, rigid, ems = tt.advance(solver, state, rigid, resort, ems)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tt.advance(solver, state, rigid, steps, ems)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = collections.defaultdict(float)
    ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            ops += 1
    if not ops:
        raise RuntimeError("the profiler recorded no device operation")
    busy = sum(by_name.values())
    costliest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "resort_every": resort,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "device_ops_per_step": ops / steps,
        "device_ms_per_step_by_op": {k: v / steps for k, v in costliest},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=_SCENE)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--settle", type=int, default=0,
                    help="steps before measuring (R=2; R=1 under linear)")
    ap.add_argument("--profile", type=int, default=0, help="profiled steps per cadence")
    ap.add_argument("--layout", choices=("seg", "linear"), default="seg",
                    help="the sweeps' layout; linear runs at R=1 only")
    ap.add_argument("--solver", choices=("wcsph", "legacy"), default="wcsph",
                    help="legacy: the reference's V1 physics (R=1 only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the port is measured on a GPU only", file=sys.stderr)
        return 2

    scene = tt.load_scene(args.scene)
    legacy = args.solver == "legacy"
    if legacy:
        solver = tt.WCSPHLegacy(scene, device="cuda", layout=args.layout)
        state, rigid = solver.bind(tt.build_state(scene, device="cuda")), None
    else:
        solver, state, rigid = tt.make_solver(scene, tt.build_state(scene, device="cuda"),
                                              device="cuda", layout=args.layout)
    ems = [tt.make_emitter_state(em, scene, "cuda") for em in scene.emitters] or None
    cadences = (2, 1) if args.layout == "seg" and not legacy else (1,)
    if args.settle:
        solver.resort_every = cadences[0]
        state, rigid, ems = tt.advance(solver, state, rigid, args.settle, ems)
    n = state.num_active

    pps, host_ms = _measure(solver, state, rigid, ems, args.steps, cadences[0])
    if pps is None:
        print(json.dumps({"metric": "particle-steps/sec", "value": 0.0,
                          "unit": "particle-steps/sec", "error": "NaN during benchmark"}))
        return 1
    resort, r1_pps = cadences[0], pps
    if len(cadences) > 1:
        r1_pps, _ = _measure(solver, state, rigid, ems, args.steps, 1)
        if r1_pps is not None and r1_pps > pps:
            pps, resort = r1_pps, 1
    what = ("V1 dam break" if legacy
            else "dam break with a dynamic rigid body" if rigid is not None
            else "dam break with emitters" if ems else "dam break")
    line = {
        "metric": f"particle-steps/sec ({scene.dim}D {what}, {n // 1000}k particles)",
        "value": round(pps, 1),
        "unit": "particle-steps/sec",
        "r1_pps": None if r1_pps is None else round(r1_pps, 1),
        "resort_every": resort,
        "host_ms_per_step": host_ms,
        "layout": args.layout,
        "solver": args.solver,
        "graphs": solver.graphs,
        "device": torch.cuda.get_device_name(0),
    }
    if args.profile:
        line["profile"] = [profile_steps(solver, state, rigid, ems, args.profile, r)
                           for r in cadences]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
