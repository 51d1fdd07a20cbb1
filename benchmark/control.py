"""The readings a cell's limits are set from: the program's check numbers
over many seeds, the control's (the reference run in bfloat16 and put in
the program's place) and each planted fault's (the program built with a
fault of ``benchmark.program.FAULTS``) on the first few of them.  Not
part of a run.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13 ... \\
        [--control 3] [--fault viscosity_dropped pressure_scaled] \\
        [--out chiprun_out/control.json]

One process: each program is built once; each seed gets its S0 and a
window of one episode at the cell's own load, then the same answers as a
run compares, with the verdict under the cell's limits as they stand.
Prints one line a seed and a JSON summary last.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from benchmark import check, harness, inputs
from benchmark.cells import load_cell
from benchmark.program import Program


def _seeds(cell, prog_cls, seeds: list[int], device, control: int = 0):
    """For each seed, the worst of the program's numbers over its
    answers, with ``control`` seeds also the control's."""
    prog = None
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        s0 = inputs.start_state(cell.scene, float(cell.config["jitter"]), seed,
                                cell.scene_path.parent)
        if prog is None:
            prog, s0_dev, _ = harness.setup(prog_cls, cell, s0, device)
        else:
            s0_dev = prog.start(s0)
        _, kept = harness.measure(prog, cell, s0_dev, s0, seed, 1, False)
        todo = harness.answers(prog, cell, kept, s0_dev, s0)
        bad = harness.nan_found(cell, kept)
        ours, ctrl = harness.judge(cell, todo, device, control=n < control)
        yield seed, check.worst(ours), bad, (check.worst(ctrl) if ctrl else None), \
            len(todo), time.perf_counter() - t0
    del prog


def readings(cell, seeds: list[int], n_control: int, faults: list[str], device) -> dict:
    out = {"workload": cell.name, "limits": cell.limits["limits"], "program": {},
           "control": {}, "faults": {f: {} for f in faults}}
    limits = cell.limits["limits"]
    runs = [("program", Program, seeds, n_control)]
    runs += [(f, functools.partial(Program, fault=f), seeds[:n_control], 0) for f in faults]
    for side, prog_cls, these, ctrl_n in runs:
        for seed, nums, bad, ctrl, answers, secs in _seeds(cell, prog_cls, these, device,
                                                           ctrl_n):
            ok = bad == 0 and check.verdict(nums, limits)
            (out["program"] if side == "program" else out["faults"][side])[seed] = \
                nums | {"nan_answers": bad, "correct": ok}
            line = f"{cell.name} {side} seed {seed}: correct {ok} {nums} nan {bad}"
            if ctrl is not None:
                out["control"][seed] = ctrl | {"correct": check.verdict(ctrl, limits)}
                line += f" control {out['control'][seed]}"
            print(line + f" ({answers} answers, {secs:.1f} s)", flush=True)
    for side, vals in [("program", out["program"]), ("control", out["control"])] + [
            (f, out["faults"][f]) for f in faults]:
        if vals:
            keys = [k for k in next(iter(vals.values())) if k not in ("nan_answers", "correct")]
            out[side + "_max"] = {k: max(r[k] for r in vals.values()) for k in keys}
            out[side + "_min"] = {k: min(r[k] for r in vals.values()) for k in keys}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="seeds that also run the control and each fault")
    ap.add_argument("--fault", nargs="*", default=[], help="faults of benchmark.program.FAULTS")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    result = []
    for w in args.workload:
        result.append(readings(load_cell(w), args.seeds, args.control, args.fault,
                               torch.device("cuda", 0)))
        torch.cuda.empty_cache()
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
