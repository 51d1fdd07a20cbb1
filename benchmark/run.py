"""The benchmark of ``tisph_tpu_torch``: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The window is the whole episodes of the cell's traffic that take about
``--seconds``, as many as the warm-up episode's time gives (at least one).
Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (answers in the window), ``failed`` (answers found wrong),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checked``: each number of the check that the cell's limits hold,
with its limit, which also end standard error (the log holds every
number of each answer).  Needs as many CUDA devices as the cell asks for: it
exits 3 without them and never measures the CPU.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tisph_tpu")


def forbidden(modules) -> list[str]:
    """The top-level names among ``modules`` (dotted names, such as the
    keys of ``sys.modules``) that the port must not load, each compared
    whole: ``tisph_tpu_torch`` is not ``tisph_tpu``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unreadable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             log=print) -> dict:
    """One run of ``cell`` on ``device``; the result line as a dict."""
    import torch

    from benchmark import harness, inputs
    from benchmark.program import Program

    s0_host = inputs.start_state(cell.scene, float(cell.config["jitter"]), seed,
                                 cell.scene_path.parent)
    prog, s0_dev, episode_s = harness.setup(Program, cell, s0_host, device)
    setup_s = time.perf_counter() - t_start
    # the whole episodes that take about ``seconds``, timed by the warm-up's
    episodes = max(1, round(seconds / episode_s))
    rec, kept = harness.measure(prog, cell, s0_dev, s0_host, seed, episodes, traced)
    rec.setup_s = setup_s
    log(f"window: {rec.steps} steps in {rec.steps // sum(harness.episode_plan(cell))} "
        f"episodes (the warm-up's took {episode_s:.6f} s), {rec.answers} answers"
        + (f", {len(rec.frame_ms)} frames" if rec.frame_ms else "") + f" in {rec.wall_s:.6f} s; "
        f"episodes' seconds {[round(e, 6) for e in rec.episode_s]}")
    if traced:
        rec.bound_ms_per_step = harness.step_bound(cell, [prog.rows(s) for s in kept.spread])
        busy_ms = rec.device.busy_s * 1e3
        log(f"traced episode: {rec.steps} steps, unprofiled wall {rec.wall_s * 1e3:.6f} ms, "
            f"profiled window {rec.device.window_s * 1e3:.6f} ms, "
            f"profiled device busy {busy_ms:.6f} ms, {rec.device.ops} device operations, "
            f"least {rec.bound_ms_per_step:.6f} ms a step")
    todo = harness.answers(prog, cell, kept, s0_dev, s0_host)
    bad = harness.nan_found(cell, kept)
    del prog, s0_dev, kept
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings, _ = harness.judge(cell, todo, device)
    for n, r in enumerate(readings):
        log(f"check: answer {n} of {len(todo)} ({todo[n][2]} steps): "
            + ", ".join(f"{k} {v!r}" for k, v in r.items()))
    limits = cell.limits["limits"]
    numbers = harness.check.worst(readings)
    wrong = bad + sum(not harness.check.verdict(r, limits) for r in readings)
    correct = wrong == 0
    metrics = {}
    for m in cell.metrics:
        if m.end_to_end == traced:
            continue
        v = m.read(rec, m.variant)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": rec.peak_mem_bytes}
    line = {"correct": bool(correct), "attempted": rec.answers,
            "failed": wrong, "metrics": metrics,
            "device": dev}
    if traced:
        dev["busy_s"] = rec.device.busy_s
        dev["window_s"] = rec.device.window_s
        line["breakdown"] = {"device_ops": harness.trace.top(rec.device.by_name),
                             "idle_gaps": harness.trace.top(rec.device.idle_by_span)}
    line["checked"] = {k: {"value": numbers.get(k, float("nan")), "limit": limits[k]}
                       for k in limits}
    line["checked"]["nan_answers"] = {"value": bad, "limit": 0}
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.cells import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), this machine has "
              f"{have}; nothing is measured on the CPU", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    print(f"card: {card_line()}", file=sys.stderr)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                    _T_START, log=lambda s: print(s, file=sys.stderr))
    found = forbidden(list(sys.modules))
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the port may load none of "
              f"{', '.join(FORBIDDEN)}", file=sys.stderr)
        return 4
    for name, c in line["checked"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
