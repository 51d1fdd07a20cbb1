"""Times of the seg sweep kernel (csrc/sweeps.cu) and of the R-group
rebuild on the states they are tuned on, for one checkout or for two in
turns.

The states: demo_3d's dense start state and its state after 252 steps (200
at R=2, 52 at R=1), bench_3d_1m's dense start state and its state after
100 steps at R=2, bench_3d_rigid after 1,602 coupled steps at R=2 (the
sphere in the water, boundary volumes from a fresh bvol pass).  On each,
every mode that scene's step launches (all five on bench_3d_rigid) is
called through its public wrapper (``ops.cuda.sweeps``), whose signature
no redesign changes, and timed with CUDA events behind a device-side spin.
So is the rebuild of that state: ``rebuild`` is the pass after the cell
sort (with ``ops.cuda.bounds.gather_and_bound``, the rebuild kernel; in
a checkout without it, one ``index_select`` per field and the bounds
kernel ``csr_bounds_sorted``), ``sort+rebuild`` the whole rebuild with the
cell ids and the sort (``sort_and_bound``; without it
``grid.sort_state_by_cell`` and ``csr_bounds_sorted``).
Prints one JSON object: ``card`` and ``ms`` {"<state> <mode>": mean ms}.

With ``--parent DIR`` (a commit unpacked into a directory that
``.gitignore`` lists, e.g. ``mkdir -p build/parent && git archive <commit>
| tar -x -C build/parent``) this file runs as a script against each
checkout's package, in the order parent, change, change, parent, each
process building its own kernels and states; the last line then holds per
state and mode both means and their ratio.  Needs a CUDA device.

Usage: python -m tisph_tpu_torch.kernel_times [--parent build/parent]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ORDER = ("parent", "change", "change", "parent")


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` warm calls; the stream is
    first held by a ~20 ms device-side spin so the launches queue up and a
    short kernel is timed back to back."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rebuilds(state, spec) -> dict:
    """{"rebuild": fn, "sort+rebuild": fn} on ``state`` with the
    importable package's rebuild (see the module's docstring)."""
    from tisph_tpu_torch.ops import grid
    from tisph_tpu_torch.ops.cuda import bounds

    ids = grid.flat_cell_ids(grid.cell_coords(state.x, spec), state.material, spec)
    sorted_ids, perm = torch.sort(ids, stable=True)
    if hasattr(bounds, "sort_and_bound"):
        return {"rebuild": lambda: bounds.gather_and_bound(state, sorted_ids, perm, spec),
                "sort+rebuild": lambda: bounds.sort_and_bound(state, spec)}
    fields = [getattr(state, f.name) for f in dataclasses.fields(state)
              if isinstance(getattr(state, f.name), torch.Tensor)]

    def sort_rebuild():
        st, ids, perm = grid.sort_state_by_cell(state, spec)
        return st, bounds.csr_bounds_sorted(ids, spec)

    return {"rebuild": lambda: ([f.index_select(0, perm) for f in fields],
                                bounds.csr_bounds_sorted(sorted_ids, spec)),
            "sort+rebuild": sort_rebuild}


def _inputs(solver, state, per_step: bool = False) -> dict:
    """The sorted state and the packs of one substep's sweeps, density from
    the kernel (the plain version is too slow at 1,000,000 dense rows), and
    the rebuild calls on ``state``."""
    from tisph_tpu_torch.models.wcsph import eos_packs, group_masses, per_step_volumes
    from tisph_tpu_torch.ops import grid, neighbors
    from tisph_tpu_torch.ops.cuda import sweeps

    spec, params = solver.spec, solver.params
    rebuilds = _rebuilds(state, spec)
    st, ids, _ = grid.sort_state_by_cell(state, spec)
    tail = (ids, grid.csr_bounds(ids, spec), st.material, spec, params)
    fl, bd = st.fluid_mask, st.boundary_mask
    pos_b = neighbors.pack4(st.x, bd.to(torch.float32))
    flm, effm = group_masses(st, fl, bd, params.density0)
    if per_step:
        vol, effm = per_step_volumes(sweeps.bvol_sweep(pos_b, *tail), bd, st.volume, flm,
                                     params.density0)
        st = dataclasses.replace(st, volume=vol)
    pos = neighbors.pack4(st.x, effm)
    _, _, vel, aux = eos_packs(sweeps.density_sweep(pos, *tail), st, fl, flm, params)
    return {"pos": pos, "pos_b": pos_b, "vel": vel, "aux": aux, "tail": tail,
            "rebuilds": rebuilds}


def measure() -> dict:
    """{"<state> <mode>": ms} of the importable ``tisph_tpu_torch``."""
    import tisph_tpu_torch as tt
    from tisph_tpu_torch.ops.cuda import sweeps

    def scene(name):
        return tt.load_scene(os.path.join(_ROOT, "scenes", name))

    states = {}
    sc = scene("demo_3d.json")
    solver = tt.WCSPH(sc, device="cuda", resort_every=2)
    state = solver.bind(tt.build_state(sc, device="cuda"))
    states["demo_3d+0"] = _inputs(solver, state)
    state = solver.rollout(state, 200)
    solver.resort_every = 1
    states["demo_3d+252"] = _inputs(solver, solver.rollout(state, 52))
    sc = scene("bench_3d_1m.json")
    solver = tt.WCSPH(sc, device="cuda", resort_every=2)
    state = solver.bind(tt.build_state(sc, device="cuda"))
    states["bench_3d_1m+0"] = _inputs(solver, state)
    states["bench_3d_1m+100"] = _inputs(solver, solver.rollout(state, 100))
    sc = scene("bench_3d_rigid.json")
    solver, state, rigid = tt.make_solver(sc, tt.build_state(sc, device="cuda"),
                                          device="cuda", resort_every=2)
    state, _ = solver.rollout_coupled(state, rigid, 1602)
    states["bench_3d_rigid+1602"] = _inputs(solver, state, per_step=True)
    del state

    ms = {}
    for label, inp in states.items():
        grad = (inp["pos"], inp["vel"], inp["aux"], *inp["tail"])
        calls = {"density": lambda: sweeps.density_sweep(inp["pos"], *inp["tail"]),
                 "force": lambda: sweeps.force_sweep(*grad)}
        if "rigid" in label:
            calls |= {"bvol": lambda: sweeps.bvol_sweep(inp["pos_b"], *inp["tail"]),
                      "force_react": lambda: sweeps.force_react_sweep(*grad),
                      "reaction": lambda: sweeps.reaction_sweep(*grad)}
        reps = 10 if "1m" in label else 20
        for mode, fn in calls.items():
            ms[f"{label} {mode}"] = (_cuda_ms(fn, reps) + _cuda_ms(fn, reps)) / 2
        for mode, fn in inp["rebuilds"].items():  # short launches: more of them
            ms[f"{label} {mode}"] = (_cuda_ms(fn, 100) + _cuda_ms(fn, 100)) / 2
    return ms


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the parent checkout; times both in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; kernels are timed on a GPU only", file=sys.stderr)
        return 2
    if args.parent is None:
        print(json.dumps({"card": _card(), "ms": measure()}))
        return 0
    roots = {"parent": os.path.abspath(args.parent), "change": _ROOT}
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    for label in _ORDER:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__)], cwd=roots[label],
                              env=dict(os.environ, PYTHONPATH=roots[label]),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_times in {roots[label]} exited {proc.returncode}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(label, json.dumps(line), flush=True)
        runs[label].append(line["ms"])
    paired = {}
    for key in runs["change"][0]:
        parent = sum(r[key] for r in runs["parent"]) / len(runs["parent"])
        change = sum(r[key] for r in runs["change"]) / len(runs["change"])
        paired[key] = {"parent_ms": parent, "change_ms": change, "ratio": change / parent}
    print(json.dumps({"card": _card(), "paired": paired}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.environ.get("PYTHONPATH", _ROOT).split(os.pathsep)[0])
    raise SystemExit(main())
