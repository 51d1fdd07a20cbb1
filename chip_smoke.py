#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tisph_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. environment: torch, CUDA, nvcc, triton, the card's name and power limit;
2. build: compiles tisph_tpu_torch/csrc/*.cu with nvcc for sm_90a;
3. bounds kernel vs its plain version (torch.searchsorted): exact
   equality on demo_3d's sorted ids, an all-sentinel and a one-particle case;
4. sweep kernel vs its plain version (ops.neighbors), modes density, force
   and bvol, on the 3D golden scene (boundary particles) and on demo_3d:
   - fast_math off: density and bvol rtol 2e-5, force / max|force| atol
     5e-6 (the JAX suite's tolerances for the same sums in another order);
   - fast_math on: the same for density and bvol (fast_math touches only
     the force mode), force / max|force| atol 1e-5: the approximate
     reciprocal (at most 2 ulp) on the two viscosity divides adds to the
     summation-order error, so twice the exact-divide bound;
5. the main path: demo_3d (195,300 particles) through load_scene ->
   build_state -> WCSPH(device="cuda").bind -> rollout, 200 steps at R=2
   then 50 at R=1; no NaN, CFL < 1, and the launch counters prove that
   every substep ran the density and force kernels and every rebuild the
   bounds kernel; then the sweep checks of phase 4 again on the evolved
   state, and kernel times against the plain versions;
6. the golden trajectories of tests/golden_{2d,3d}_dam_break.npz at R=1,
   fast_math off and on, at the tolerances of tests/test_golden.py.

The last two lines of standard output are the JSON kernel summary and
{"ok": true, "device": {...}}; any failure exits nonzero before them.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEMO_3D = os.path.join(HERE, "scenes", "demo_3d.json")
DEVICE = "cuda"
STEPS_R2, STEPS_R1 = 200, 50

# tests/test_golden.py's scenes and step counts
GOLDEN = {
    "2d_dam_break": ({
        "configuration": {
            "dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [2.0, 1.0],
            "particleRadius": 0.02, "density0": 1000,
            "gravitation": [0.0, -9.81], "c_s": 50.0,
        },
        "boundaryBlocks": [{"start": [0.9, 0.08], "end": [1.1, 0.3]}],
        "fluidBlocks": [{"start": [0.1, 0.1], "end": [0.5, 0.5],
                         "velocity": [1.0, 0.0], "density": 1000.0,
                         "color": [50, 100, 200]}],
    }, 40),
    "3d_dam_break": ({
        "configuration": {
            "dim": 3, "domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.6, 1.0, 1.0],
            "particleRadius": 0.025, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0,
        },
        "boundaryBlocks": [{"start": [0.7, 0.05, 0.3], "end": [0.9, 0.25, 0.7]}],
        "fluidBlocks": [{"start": [0.08, 0.08, 0.08], "end": [0.45, 0.5, 0.5],
                         "velocity": [1.0, 0.0, 0.0], "density": 1000.0,
                         "color": [50, 100, 200]}],
    }, 30),
}

TOL = {  # (density and bvol rtol, force atol after scaling by max|force|)
    False: (2e-5, 5e-6),
    True: (2e-5, 1e-5),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` warm calls (CUDA events).

    The stream is first held by a ~20 ms device-side spin, so the host
    queues all the launches before the first one runs and a kernel shorter
    than its launch overhead is timed back to back rather than at the
    host's launch rate.  A plain version that synchronises inside is timed
    with its host waits, which are part of its cost."""
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


def reset_counts(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def sweep_inputs(solver, state):
    """Sorted state and the sweep packs of one substep's density and force
    calls (density from the plain version, so both sides of every
    comparison read identical inputs)."""
    from tisph_tpu_torch.ops import forces as F
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.grid import csr_bounds, sort_state_by_cell

    spec, params = solver.spec, solver.params
    st, ids, _ = sort_state_by_cell(state, spec)
    bounds = csr_bounds(ids, spec)
    fl = st.fluid_mask
    bd = st.boundary_mask.to(torch.float32)
    flm = fl.to(torch.float32) * st.mass
    effm = flm + bd * (params.density0 * st.volume)
    pos = neighbors.pack4(st.x, effm)
    rho = neighbors.density_sweep(pos, ids, bounds, st.material, spec, params)
    rho, p = F.compute_pressures(torch.where(fl, rho, st.density), params)
    p_rho2 = p / torch.clamp(rho * rho, min=1e-12)
    return {
        "st": st, "ids": ids, "bounds": bounds,
        "pos": pos, "pos_b": neighbors.pack4(st.x, bd),
        "vel": neighbors.pack4(st.v, rho),
        "aux": neighbors.pack_aux(p_rho2, flm, st.mass),
    }


def check_sweeps(label: str, solver, inp) -> dict[str, float]:
    """Kernel vs plain for the three modes at both fast_math settings;
    returns the max abs error per mode at fast_math on (the main path's)."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import sweeps

    spec, params = solver.spec, solver.params
    st, ids, bounds, mat = inp["st"], inp["ids"], inp["bounds"], inp["st"].material
    fl, bd = st.fluid_mask, st.boundary_mask
    ref = {
        "density": neighbors.density_sweep(inp["pos"], ids, bounds, mat, spec, params),
        "bvol": neighbors.bvol_sweep(inp["pos_b"], ids, bounds, mat, spec, params),
        "force": neighbors.force_sweep(inp["pos"], inp["vel"], inp["aux"], ids, bounds,
                                       mat, spec, params),
    }
    errs = {}
    for fast in (False, True):
        rtol, atol_f = TOL[fast]
        got = {
            "density": sweeps.density_sweep(inp["pos"], ids, bounds, mat, spec, params, fast),
            "bvol": sweeps.bvol_sweep(inp["pos_b"], ids, bounds, mat, spec, params, fast),
            "force": sweeps.force_sweep(inp["pos"], inp["vel"], inp["aux"], ids, bounds,
                                        mat, spec, params, fast),
        }
        torch.cuda.synchronize()
        for mode, rows in (("density", fl), ("bvol", bd), ("force", fl)):
            g, r = got[mode], ref[mode]
            if not torch.isfinite(g).all():
                raise AssertionError(f"{label} {mode} fast={fast}: non-finite output")
            if not torch.equal(g[~rows], torch.zeros_like(g[~rows])):
                raise AssertionError(f"{label} {mode}: rows outside its family not 0")
            err = float((g - r).abs().max()) if g.numel() else 0.0
            if mode == "force":
                scale = float(r[rows].abs().max()) if bool(rows.any()) else 1.0
                rel = err / scale
                ok = rel <= atol_f
                detail = f"max|err|/max|ref| = {rel:.3e} (atol {atol_f})"
            else:
                denom = r[rows].abs().clamp(min=1e-30)
                rel = float(((g - r)[rows].abs() / denom).max()) if bool(rows.any()) else 0.0
                ok = rel <= rtol
                detail = f"max rel err = {rel:.3e} (rtol {rtol})"
            print(f"  {label:<12} {mode:<8} fast_math={int(fast)} rows={int(rows.sum())} "
                  f"max|err|={err:.3e} {detail}")
            if not ok:
                raise AssertionError(f"{label} {mode} fast={fast}: {detail}")
            if fast:
                errs[mode] = err
    return errs


def golden_check(tt, name: str, raw: dict, steps: int, fast_math: bool) -> dict:
    """Run a golden scene at R=1 and match its particles to the recorded
    ones.  The recording is ordered by position, and a 1-ulp difference
    reorders particles with equal coordinates, so each particle is matched
    to the recorded one of least cost max(|dx|/5e-5, |dv|/5e-2,
    |drho|/(5e-4 rho)) (test_golden's tolerances): the run reproduces the
    golden iff that matching is one to one with every cost <= 1."""
    scene = tt.scene_from_dict(raw)
    solver = tt.WCSPH(scene, device=DEVICE, resort_every=1, fast_math=fast_math)
    out = tt.state_to_host(solver.rollout(solver.bind(tt.build_state(scene, device=DEVICE)),
                                          steps))
    with np.load(os.path.join(HERE, "tests", f"golden_{name}.npz")) as z:
        ref = {k: torch.as_tensor(z[k]) for k in z.files}
    got = {k: torch.as_tensor(v) for k, v in out.items()}
    f64 = {k: (got[k].double(), ref[k].double()) for k in ("x", "v", "density")}
    inf = float("inf")
    cost = torch.maximum(torch.cdist(*f64["x"], p=inf) / 5e-5, torch.cdist(*f64["v"], p=inf) / 5e-2)
    rho_g, rho_r = f64["density"]
    cost = torch.maximum(cost, (rho_g[:, None] - rho_r[None, :]).abs() / (5e-4 * rho_r.abs()))
    best, idx = cost.min(dim=1)
    one_to_one = len(ref["x"]) == len(got["x"]) == len(torch.unique(idx))
    same_mat = bool((got["material"] == ref["material"][idx]).all())
    worst = float(best.max())
    print(f"  golden {name} fast_math={int(fast_math)}: {len(got['x'])} particles, "
          f"one to one {one_to_one}, materials equal {same_mat}, "
          f"worst cost {worst:.4f} (<= 1 passes)")
    return {"ok": one_to_one and same_mat and worst <= 1.0, "worst": worst}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs "
              "on a CUDA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import tisph_tpu_torch as tt
    from tisph_tpu_torch.ops import grid as gridops
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
    from tisph_tpu_torch.ops.cuda import build
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps

    kernels = {
        "csr_bounds": cuda_bounds.csr_bounds_sorted,
        "sweep.density": cuda_sweeps.density_sweep,
        "sweep.force": cuda_sweeps.force_sweep,
        "sweep.bvol": cuda_sweeps.bvol_sweep,
    }

    phase("1 environment")
    nvcc_v = subprocess.run([build._nvcc(), "--version"], check=True,
                            capture_output=True, text=True).stdout.strip().splitlines()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    card_line = card()
    print(f"  python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} triton {triton_v}")
    print(f"  nvcc: {nvcc_v[-1]}")
    print(f"  device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase("2 build")
    path, secs = build.build()
    build.load()
    print(f"  {path.name}: nvcc {secs:.2f} s")

    phase("3 bounds kernel vs torch.searchsorted")
    scene = tt.load_scene(DEMO_3D)
    solver = tt.WCSPH(scene, device=DEVICE, resort_every=2)
    state = solver.bind(tt.build_state(scene, device=DEVICE))
    spec = solver.spec
    _, ids, _ = gridops.sort_state_by_cell(state, spec)
    cases = {
        "demo_3d": ids,
        "all_sentinel": torch.full((1000,), spec.num_cells, dtype=torch.int32, device=DEVICE),
        "one_particle": ids[state.num_active // 2: state.num_active // 2 + 1].clone(),
    }
    bounds_err = 0
    for label, c in cases.items():
        got = cuda_bounds.csr_bounds_sorted(c, spec)
        ref = gridops.csr_bounds(c, spec)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"bounds {label}: kernel != searchsorted")
        bounds_err = max(bounds_err, int((got - ref).abs().max()))
        print(f"  {label}: n={c.numel()} cells={spec.num_cells + 1} equal")

    phase("4 sweep kernel vs plain")
    g_scene = tt.scene_from_dict(GOLDEN["3d_dam_break"][0])
    g_solver = tt.WCSPH(g_scene, device=DEVICE)
    g_inp = sweep_inputs(g_solver, g_solver.bind(tt.build_state(g_scene, device=DEVICE)))
    errs_bvol = check_sweeps("golden_3d", g_solver, g_inp)
    check_sweeps("demo_3d", solver, sweep_inputs(solver, state))

    phase(f"5 main path: demo_3d, {STEPS_R2} steps at R=2, {STEPS_R1} at R=1")
    n = state.num_active
    state = solver.rollout(state, 2)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    state = solver.rollout(state, STEPS_R2)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    after_r2 = {k: f.launches for k, f in kernels.items()}
    solver.resort_every = 1
    t0 = time.perf_counter()
    state = solver.rollout(state, STEPS_R1)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    groups = -(-STEPS_R2 // 2)
    want_r2 = {"csr_bounds": groups, "sweep.density": STEPS_R2, "sweep.force": STEPS_R2,
               "sweep.bvol": 0}
    total = STEPS_R2 + STEPS_R1
    want = {"csr_bounds": groups + STEPS_R1, "sweep.density": total, "sweep.force": total,
            "sweep.bvol": 0}
    if after_r2 != want_r2 or launches != want:
        raise AssertionError(f"launch counts {after_r2} then {launches}, "
                             f"expected {want_r2} then {want}")
    m = solver.metrics(state)
    print(f"  launches: {launches}")
    print(f"  metrics: {m}")
    if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
        raise AssertionError(f"main path unhealthy: {m}")
    pps2, pps1 = n * STEPS_R2 / wall2, n * STEPS_R1 / wall1
    print(f"  {n} particles: R=2 {pps2:.6e} particle-steps/s "
          f"({wall2 * 1e3 / STEPS_R2:.4f} ms/step), R=1 {pps1:.6e} particle-steps/s "
          f"({wall1 * 1e3 / STEPS_R1:.4f} ms/step) on {card_line}")

    # The boundary-volume mode runs at bind; demo_3d has no boundary, so its
    # launch is counted on the golden 3D scene's bind (the same main path).
    reset_counts(kernels)
    g_solver2 = tt.WCSPH(g_scene, device=DEVICE)
    g_state = g_solver2.bind(tt.build_state(g_scene, device=DEVICE))
    g_solver2.rollout(g_state, 2)
    torch.cuda.synchronize()
    if cuda_sweeps.bvol_sweep.launches != 1:
        raise AssertionError(f"bvol launches {cuda_sweeps.bvol_sweep.launches} at bind, want 1")
    launches["sweep.bvol"] = cuda_sweeps.bvol_sweep.launches

    print("  sweep checks on the evolved demo_3d state:")
    inp = sweep_inputs(solver, state)
    errs = check_sweeps("demo_3d+250", solver, inp)
    errs["bvol"] = errs_bvol["bvol"]
    st, ids, bnd, mat = inp["st"], inp["ids"], inp["bounds"], inp["st"].material
    sp, pr = solver.spec, solver.params
    timing = {
        "csr_bounds": (lambda: cuda_bounds.csr_bounds_sorted(ids, sp),
                       lambda: gridops.csr_bounds(ids, sp), 200, 200),
        "sweep.density": (
            lambda: cuda_sweeps.density_sweep(inp["pos"], ids, bnd, mat, sp, pr),
            lambda: neighbors.density_sweep(inp["pos"], ids, bnd, mat, sp, pr), 20, 2),
        "sweep.force": (
            lambda: cuda_sweeps.force_sweep(inp["pos"], inp["vel"], inp["aux"], ids, bnd,
                                            mat, sp, pr),
            lambda: neighbors.force_sweep(inp["pos"], inp["vel"], inp["aux"], ids, bnd,
                                          mat, sp, pr), 20, 2),
        "sweep.bvol": (
            lambda: cuda_sweeps.bvol_sweep(g_inp["pos_b"], g_inp["ids"], g_inp["bounds"],
                                           g_inp["st"].material, g_solver.spec,
                                           g_solver.params),
            lambda: neighbors.bvol_sweep(g_inp["pos_b"], g_inp["ids"], g_inp["bounds"],
                                         g_inp["st"].material, g_solver.spec,
                                         g_solver.params), 50, 5),
    }
    times = {}
    for name, (kern, plain, reps, preps) in timing.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p_a = cuda_ms(plain, preps)
        k_a = cuda_ms(kern, reps)
        k_b = cuda_ms(kern, reps)
        p_b = cuda_ms(plain, preps)
        times[name] = ((k_a + k_b) / 2, (p_a + p_b) / 2)
        print(f"  time {name:<14} kernel {k_a:.4f} / {k_b:.4f} ms   "
              f"plain {p_a:.4f} / {p_b:.4f} ms")

    phase("6 golden trajectories (R=1)")
    for name, (raw, steps) in GOLDEN.items():
        for fast in (False, True):
            if not golden_check(tt, name, raw, steps, fast_math=fast)["ok"]:
                raise AssertionError(f"golden {name} fast_math={fast} outside the "
                                     "test_golden tolerances")

    src = {"csr_bounds": ("tisph_tpu_torch/csrc/bounds.cu", "tisph_tpu/ops/pallas/bounds.py:43")}
    for k in ("sweep.density", "sweep.force", "sweep.bvol"):
        src[k] = ("tisph_tpu_torch/csrc/sweeps.cu", "tisph_tpu/ops/pallas/sweeps.py:787")
    errs["csr_bounds"] = float(bounds_err)
    summary = {"kernels": [
        {"name": k, "route": "cuda", "source": src[k][0], "replaces": src[k][1],
         "launches": launches[k], "max_abs_err": errs[k.split(".")[-1]],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k in kernels
    ]}
    print(card_line)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
