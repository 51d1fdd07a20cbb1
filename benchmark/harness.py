"""One run of a cell: set-up, the measured window, the traced pass, the
answers for the check, and the metrics.

The traffic mix is a file of parameters that :func:`drive` reads
(``benchmark/traffic/<mix>.json``):

- ``episode_steps``: an episode advances the seeded start state S0 by
  this many steps, then the next starts from S0 again; a window is whole
  episodes, so a run does the same work per step whatever the program's
  speed and however long its window;
- ``chunk_steps``: the steps of one ``advance`` call (the episode's last
  takes the rest); each call's result is an answer;
- ``dump``: each answer is copied to host arrays (``state_to_host``), as
  the reference's frame loop does before it draws;
- ``health_read``: the state's ``nan_count`` is read at each episode's end;
- ``resort_every``: the rebuild cadence R, or null for the configuration's;
- ``check_random``: how many answers at positions drawn from the seed the
  check compares, besides the episode's first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from benchmark import check, inputs, trace, work

# states of the traced pass spread over its episode, for the pair counts
PAIR_STATES = 10


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""

    traffic: str
    particles: int
    setup_s: float = 0.0
    steps: int = 0
    wall_s: float = 0.0
    answers: int = 0
    peak_mem_bytes: int = 0
    frame_ms: list[float] = dataclasses.field(default_factory=list)
    dump_ms: list[float] = dataclasses.field(default_factory=list)
    queue_ms: list[float] = dataclasses.field(default_factory=list)  # host ms a step, a call
    # each episode's seconds to its end (a health read or a dump waits for the device)
    episode_s: list[float] = dataclasses.field(default_factory=list)
    # the traced run: one unprofiled episode (the fields above), then its
    # profiled copy, whose trace holds the device's busy time and the traced window
    device: trace.DeviceTrace | None = None
    bound_ms_per_step: float | None = None


@dataclasses.dataclass
class Kept:
    """What the window leaves for the check: by position in the episode,
    (input, answer) of the latest episode that reached it, each a device
    state or, with ``dump``, host arrays; the dumps at the episodes' ends;
    with ``spread``, states spread over the episode."""

    pairs: dict[int, tuple] = dataclasses.field(default_factory=dict)
    ends: list = dataclasses.field(default_factory=list)
    spread: list = dataclasses.field(default_factory=list)
    nan_reads: int = 0  # health reads that found a NaN


def resort_every(cell) -> int:
    r = cell.traffic.get("resort_every")
    return int(r if r is not None else cell.config["resort_every"])


def episode_plan(cell) -> list[int]:
    """The steps of each ``advance`` call of an episode."""
    e, c = int(cell.traffic["episode_steps"]), int(cell.traffic["chunk_steps"])
    return [c] * (e // c) + ([e % c] if e % c else [])


def check_positions(cell, seed: int) -> list[int]:
    """The answers the check compares: the episode's first, and
    ``check_random`` more at positions drawn from the seed, never the
    second: its input is the first's answer, so the window would hold one
    state fewer for the check, and the run's peak memory would depend on
    the seed."""
    n = len(episode_plan(cell))
    k = max(0, min(int(cell.traffic["check_random"]), n - 2))
    extra = np.random.default_rng([seed, 1]).choice(np.arange(2, n), size=k, replace=False)
    return [0] + sorted(int(p) for p in extra)


def _spans(on: bool):
    """``span(name)``: a ``record_function`` range for the trace, or nothing."""
    if on:
        return lambda name: torch.profiler.record_function(trace.SPAN_PREFIX + name)
    return lambda name: contextlib.nullcontext()


def drive(prog, cell, s0_dev, s0_host, rec: Record, kept: Kept, keep: set[int],
          episodes: int, *, spans: bool = False, spread: bool = False) -> None:
    """The closed loop: ``episodes`` whole episodes from S0, then a wait
    for the device.  Records the steps, the wall time, the host ms a step
    to queue each call and, with ``dump``, each frame's ms (from its
    ``advance`` call to its host arrays) and its dump's."""
    plan = episode_plan(cell)
    dump, health = bool(cell.traffic["dump"]), bool(cell.traffic["health_read"])
    every = max(1, math.ceil(len(plan) / PAIR_STATES))
    span = _spans(spans)
    t0 = time.perf_counter()
    for _ in range(episodes):
        with span("episode_start"):
            state, answer = s0_dev, (s0_host if dump else s0_dev)
        for pos, k in enumerate(plan):
            t_call = time.perf_counter()
            with span("advance"):
                out = prog.advance(state, k)
            t_ret = time.perf_counter()
            rec.queue_ms.append((t_ret - t_call) * 1e3 / k)
            new = out
            if dump:
                with span("state_to_host"):
                    new = prog.dump(out)
                t_end = time.perf_counter()
                rec.dump_ms.append((t_end - t_ret) * 1e3)
                rec.frame_ms.append((t_end - t_call) * 1e3)
            if pos in keep:
                kept.pairs[pos] = (answer, new)
            if spread and pos % every == 0:
                kept.spread.append(answer)
            rec.steps += k
            rec.answers += 1
            state, answer = out, new
        if health:
            with span("health_read"):
                kept.nan_reads += prog.health(state) > 0
        if dump:
            kept.ends.append(answer)
        rec.episode_s.append(time.perf_counter() - t0 - sum(rec.episode_s))
    prog.synchronize()
    rec.wall_s = time.perf_counter() - t0


def setup(prog_cls, cell, s0_host, device):
    """The program, its bound S0, every call shape of the traffic warmed
    up (kernels built, graphs captured), then one episode run through;
    returns them and that episode's seconds."""
    prog = prog_cls(cell, device, resort_every(cell))
    s0_dev = prog.start(s0_host)
    for k in sorted(set(episode_plan(cell))):
        out = prog.advance(s0_dev, k)
        if cell.traffic["dump"]:
            prog.dump(out)
        if cell.traffic["health_read"]:
            prog.health(out)
    rec = Record(cell.traffic_name, int(s0_host["num_active"]))
    drive(prog, cell, s0_dev, s0_host, rec, Kept(), set(), 1)
    return prog, s0_dev, rec.wall_s


def measure(prog, cell, s0_dev, s0_host, seed: int, episodes: int, traced: bool
            ) -> tuple[Record, Kept]:
    """The window of ``episodes`` whole episodes; ``traced``: one episode,
    then that episode again under the profiler."""
    rec, kept = Record(cell.traffic_name, int(s0_host["num_active"])), Kept()
    keep = set(check_positions(cell, seed))
    drive(prog, cell, s0_dev, s0_host, rec, kept, keep, 1 if traced else episodes,
          spread=traced)
    if prog.device.type == "cuda":
        rec.peak_mem_bytes = torch.cuda.max_memory_allocated(prog.device)
    if traced:
        rec.device = trace.profiled(lambda: drive(
            prog, cell, s0_dev, s0_host, Record(rec.traffic, rec.particles), Kept(), set(), 1,
            spans=True))
    return rec, kept


def step_bound(cell, states: list[dict]) -> float:
    """The least ms of a step on the card (``work.step_bound_ms``), with
    the pairs inside h averaged over ``states``: each the ``x`` and
    ``material`` of every row, host arrays or tensors (``Program.rows``)."""
    scene = cell.scene["configuration"]
    dim = int(scene.get("dim", len(scene["domainStart"])))
    start, end = scene["domainStart"][:dim], scene["domainEnd"][:dim]
    h = 4.0 * float(scene["particleRadius"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    kind = cell.config["solver"]
    totals: dict[str, float] = {}
    for st in states:
        x, mat = (torch.as_tensor(st[k], device=dev) for k in ("x", "material"))
        for k, v in work.count_pairs(x, mat, h, start, end, boundary=kind == "rigid").items():
            totals[k] = totals.get(k, 0) + v / len(states)
    mat = torch.as_tensor(states[0]["material"])
    phases = work.step_bound_ms(kind, dim, int(mat.shape[0]), int((mat == 1).sum()),
                                work.grid_cells(start, end, h), resort_every(cell), totals,
                                bodies=len(inputs.dynamic_bodies(cell.scene)))
    return sum(phases.values())


def answers(prog, cell, kept: Kept, s0_dev, s0_host) -> list[tuple]:
    """The answers to compare, as (input, answer, steps, replay): host
    arrays, the steps between them, and ``check``'s ``replay`` flag.  A
    dumped answer is judged from its input, the previous frame's dump or
    S0.  A chunk's answer is judged from the program's state one group
    before its end: the check runs the chunk's input that far and then
    one group on, and that end has to be bitwise the window's answer (the
    reference follows the program a group at a time there).  The start
    check judges the program's first group from S0."""
    R = resort_every(cell)
    plan = episode_plan(cell)
    if cell.traffic["dump"]:
        return [(inp, out, plan[p], 0) for p, (inp, out) in sorted(kept.pairs.items())]
    first = prog.advance(s0_dev, R)
    todo = [(s0_host, prog.to_host(first), R, 0)]
    for p, (inp, out) in sorted(kept.pairs.items()):
        k = plan[p]
        pre = prog.advance(inp, k - R) if k > R else inp
        pre_host = prog.to_host(pre)
        last = prog.advance(pre, R)
        todo.append((pre_host, prog.to_host(out), R, int(not prog.same(last, out))))
    return todo


def nan_found(cell, kept: Kept) -> int:
    """Health reads, or dumps at the episodes' ends, that hold a NaN."""
    bad = kept.nan_reads
    for d in kept.ends:
        if isinstance(d, dict):
            bad += not (np.isfinite(d["x"]).all() and np.isfinite(d["v"]).all())
    return bad


def judge(cell, todo: list[tuple], device, control: bool = False
          ) -> tuple[list[dict[str, float]], list[dict[str, float]]]:
    """The check's numbers of each answer, and with ``control`` the same
    numbers of the bfloat16 reference put in the program's place."""
    R = resort_every(cell)
    readings, ctrl = [], []
    for inp, out, steps, replay in todo:
        ref = check.reference_steps(cell, inp, steps, R, device)
        readings.append(check.compare(cell, inp, out, ref, replay))
        if control:
            low = check.reference_steps(cell, inp, steps, R, device, torch.bfloat16)
            ctrl.append(check.compare(cell, inp, check.as_answer(low, inp), ref))
        del ref
    return readings, ctrl
