"""Paired benchmark of two checkouts on one GPU.

Runs this checkout's ``tisph_tpu_torch/bench.py`` against each
checkout's package on each scene, in the order parent, change, change,
parent, ``--rounds`` times over, so
that both versions share the card and the host's load in turns: the host
clock's spread between runs is wider than most changes (PERF.md section
2).  Prints every bench line tagged with its checkout and scene, then, as
its last line, one JSON object of medians per checkout and scene:
``value`` (the bench's faster cadence), ``r1_pps`` (R=1) and
``host_ms_per_step``, and with
``--profile N`` per cadence the medians of the profile's device busy ms
and device operations per step.

Each checkout runs its own package and builds its own kernels under its
own ``build/``; the harness is the same file for both, so a bench option
the parent's own bench lacks (``--solver``, ``--host-pace``) times the
parent as well.  A parent checkout is a commit unpacked into a directory
that ``.gitignore`` lists, e.g. ``mkdir -p build/parent && git archive
<commit> | tar -x -C build/parent``.  Needs a CUDA device, as the bench
does; a failed bench run raises.

Usage: python -m tisph_tpu_torch.paired_bench --parent build/parent
           [--change .] [--rounds 2] [--steps 300] [--settle N] [--profile N]
           [--solver {wcsph,legacy}] [--host-pace]
           [--scene scenes/demo_3d.json --scene scenes/bench_3d_rigid.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_SCENES = ("scenes/demo_3d.json", "scenes/bench_3d_rigid.json")
_BENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench.py")
_ORDER = ("parent", "change", "change", "parent")


_PROFILED = ("device_busy_ms_per_step", "device_ops_per_step")


def _bench(root: str, scene: str, steps: int, extra: list[str]) -> dict:
    """One bench run on the package of the checkout at ``root``; its JSON
    line."""
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, _BENCH, "--scene", scene, "--steps", str(steps), *extra],
        cwd=root, env=env, capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"bench in {root} on {scene} exited {proc.returncode}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the parent checkout")
    ap.add_argument("--change", default=".", help="root of the changed checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scene", action="append", help="relative to each checkout's root")
    ap.add_argument("--settle", type=int, default=0, help="passed to the bench")
    ap.add_argument("--profile", type=int, default=0, help="passed to the bench")
    ap.add_argument("--solver", choices=("wcsph", "legacy"), default="wcsph",
                    help="passed to the bench")
    ap.add_argument("--host-pace", action="store_true", help="passed to the bench")
    args = ap.parse_args(argv)
    extra = ["--settle", str(args.settle), "--profile", str(args.profile),
             "--solver", args.solver] + (["--host-pace"] if args.host_pace else [])
    roots = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    scenes = args.scene or list(_SCENES)

    runs: dict[tuple[str, str], list[dict]] = {}
    for _ in range(args.rounds):
        for label in _ORDER:
            for scene in scenes:
                line = _bench(roots[label], scene, args.steps, extra)
                print(label, scene, json.dumps(line), flush=True)
                runs.setdefault((label, scene), []).append(line)
    medians = {}
    for (label, scene), lines in runs.items():
        med = {"value": statistics.median(r["value"] for r in lines),
               "r1_pps": statistics.median(r["r1_pps"] for r in lines),
               "host_ms_per_step": statistics.median(r["host_ms_per_step"] for r in lines),
               "runs": len(lines)}
        for i, prof in enumerate(lines[0].get("profile", [])):
            med[f"R={prof['resort_every']}"] = {
                k: statistics.median(r["profile"][i][k] for r in lines) for k in _PROFILED}
        medians[f"{label} {scene}"] = med
    print(json.dumps({"medians": medians}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
