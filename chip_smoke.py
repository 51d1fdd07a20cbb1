#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tisph_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. environment: torch, CUDA, nvcc, triton, the card's name and power
   limit, and whether torch.cuda.CUDAGraph has begin_capture_to_if_node
   (a conditional graph node, which the slab's seam guard would need to
   run one resort branch on the graph path);
2. build: compiles tisph_tpu_torch/csrc/*.cu (bounds.cu, sweeps.cu,
   sweeps_linear.cu, legacy.cu, pointwise.cu) with nvcc for sm_90a;
3. the rebuild kernel (csrc/bounds.cu through ops.cuda.bounds.sort_and_bound:
   after the cell sort, every state field in sorted order and the CSR
   bounds in one launch) vs its plain version (grid.sort_state_by_cell
   then grid.csr_bounds): every field, the sorted ids, the permutation and
   the bounds bitwise equal on demo_3d's start state (an inactive tail),
   bench_3d_1m's, bench_3d_rigid's, the 2D golden scene (13 words a row),
   demo_3d with 1,504 inactive rows, all rows inactive, one particle and
   a cell of 10,000 particles (more ids than a bounds CTA holds); the same
   on phase 5's evolved state and on phase 7's and phase 10's; and the
   bounds-only launch (csr_bounds_sorted) vs torch.searchsorted on
   demo_3d's sorted ids, an all-sentinel and a one-particle case;
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
   then 50 at R=1; one R=2 group queued behind a device-side spin must
   return before the spin ends (no host wait in the step); no NaN,
   CFL < 1, and the launch counters prove that every substep ran the
   density and force kernels and every rebuild the rebuild kernel; 20
   more steps at R=2 through rollout are bitwise equal to the same 20
   steps built from the plain rebuild (sort_state_by_cell, csr_bounds,
   _group_cache, _apply); the rebuild's times (kernel, plain version,
   bound, and the library calls of the same work: torch.searchsorted and
   the nine index_selects) on four states; then the
   sweep checks of phase 4 again on the evolved state, and kernel times
   against the plain versions there and of both sweeps on the dense start
   state; beside each time the state's candidates per consumer row, its
   pairs inside h per row, their ratio, and the launch shape the wrapper
   chose (threads per row, CTAs);
6. the golden trajectories of tests/golden_{2d,3d}_dam_break.npz at R=1,
   fast_math off and on, at the tolerances of tests/test_golden.py;
7. the rigid main path: scenes/bench_3d_rigid.json (60,858 particles, a
   666-particle sphere dropped into a dam break) through load_scene ->
   build_state -> make_solver (WCSPHRigid(device="cuda").bind ->
   init_rigid) -> rollout_coupled, 1,500 steps at R=2 then 100 at R=1;
   one coupled R=2 group must queue without a host wait, as in phase 5;
   the launch counters prove that every substep ran the bvol, density and
   force_react kernels (and never force or reaction) and every rebuild the
   rebuild kernel; no NaN, CFL < 1, body shape drift max | |x_p - com| - d0 |
   < 1e-4, the sphere's com_y below its start; then, on the final state
   with its volumes from a fresh bvol pass and the sphere in the water,
   every sweep mode kernel vs plain at fast_math off and on: bvol, density
   and force at phase 4's tolerances, force_react and reaction with fluid
   rows as force, boundary rows scaled by max|reaction| at the same
   bounds, exact 0 off the family; and the times of bvol, force_react and
   reaction against the plain versions on that state, with force and
   force_react at fast_math off beside them;
8. buoyancy: tests/test_rigid_dynamics.py::test_buoyancy's scenes (a box
   of density 200 or 5000 dropped into a calm pool), 2,000 steps at R=1:
   the light box ends with com_y > 0.27, the heavy one below;
9. the linear main path: demo_3d through load_scene -> build_state ->
   WCSPH(device="cuda", layout="linear").bind -> rollout, 100 steps at R=1;
   one step queued behind the device spin must return without a host
   wait; the launch counters prove that every substep ran the linear
   kernel's density and force modes and the rebuild kernel, and never the
   seg sweeps; no NaN, CFL < 1; then, on three states (the evolved one,
   demo_3d's dense start state, and a lattice at 0.63 of the radius spacing
   whose largest block stream fills the kernel's shared-memory chunk many
   times over), the linear kernel against its plain version at phase 4's
   tolerances and against the seg kernel (density bitwise equal, force at
   the same tolerance), fast_math off and on, its block windows against
   grid.block_window_bounds exactly, and its candidates per block beside
   the chunk capacity; the times of both kernels and the plain version on
   the evolved state and of both kernels on the dense start state; the
   golden trajectories through layout="linear", fast_math off and on;
10. a large launch: bench_3d_1m (1,000,000 particles) 20 steps at R=2,
   kernel A at one thread per row against its plain version and kernel C;
11. the emitter path: scenes/bench_3d_mesh_500k.json (520,000 fluid
   particles, the Dragon mesh's boundary particles and an emitter of one
   batch every 100 steps into a pool of 50,000) through load_scene ->
   build_state -> WCSPH(device="cuda", resort_every=2).bind ->
   rollout_emit, 600 steps at R=2 then 100 at R=1: 7 emissions, 6 of them
   after their group's rebuild; the launch counters prove bvol once at
   bind, density and force every substep, the rebuild once per group and
   at bind, force_react and reaction never; emitted and num_active equal
   the host's count of the cadence, the emitted rows are fluid with
   object_id 10,000, no NaN, CFL < 1; the groups are graph replays, one
   capture per fire pattern and group length; one R=2 group that emits
   must queue without a host wait; then, on a state captured right after an emission
   on a group's second substep: the sweep kernels with the group's
   sort-time material against their plain versions at phase 4's
   tolerances, fast_math off and on (the emitted rows outside every
   family: exactly 0), and one step through _apply against the same step
   with the plain sweeps: the emitted rows keep their density and
   emission velocity exactly and move by dt v in both;
12. checkpoint on the card: phase 11's bound solver runs its start state
   200 steps at R=2 with the emitter, and 100 steps, save_npz, load_npz to
   the card and 100 more (emissions at steps 0 and 100): the two end
   states and emitter counters bitwise equal;
13. the legacy V1 solver (WCSPHLegacy) on scenes/demo_2d.json, whose two
   pair sums are the kernel csrc/legacy.cu (ops.cuda.legacy): 500 steps
   on the graph path (one replay a step) against graphs=False from the
   same start, every field bitwise equal, with launch counts that count
   replays (a rebuild, a density and a force launch a step, on both
   paths); 20 steps on the card against 20 on the CPU (x atol 1e-5, rows
   matched by a tag in color[:, 0]); no NaN, CFL < 1, fluid inside the
   padded box; one eager step (_build and _apply) queued behind the spin
   under torch's sync debug mode "error"; the kernel at every lane count
   it is built for (4, 16) against its plain version
   (ops.neighbors.legacy_*), two calls bitwise equal and 0 off the fluid
   rows, density rtol 2e-5 and force / max|force| atol 5e-6 (each margin
   printed), the rule's launch (ops.cuda.legacy.legacy_launch_shape)
   bitwise the count it picks, on demo_2d's state after the 500 steps, on
   the 3D golden scene's start (a boundary block), on demo_3d after 252
   and bench_3d_1m after 20 legacy steps (graph replays, a rebuild, a
   density and a force launch a step); an unbuilt lane count raises; 100
   steps of the golden scene with boundary_mode="per_step" (a bvol, a
   density and a force launch in one graph a step) bitwise graphs=False;
   the kernel's times at every lane count on those four states and
   demo_3d's dense start, with the rule's launch shape, its bound
   (operations counted at the state's dim) and the share of it reached;
   its times against the plain version on demo_2d's state; then both
   paths in turns (eager, graph, graph, eager) at R=1, as phase 23, on
   demo_2d (500 steps) and demo_3d (200);
14. the 1-D sharded solver (tisph_tpu_torch.parallel.ShardedWCSPH) on
   demo_3d, on 2 and on 4 shards that all live on the one card (so its
   particle-steps/s is the exchange's cost, not scaling): 100 steps at R=2
   through bind -> rollout; after 20 of them the global state against the
   single-device WCSPH run from the same start (rows by a tag in
   color[:, 0]; x atol 1e-5, v 5e-3, density rtol 1e-4,
   tests/test_parallel.py:66-71); the launch counters prove a density and a
   force launch of kernel A over its rows per shard per substep, and per
   group a rebuild launch per shard (one for the whole array when the seam
   guard falls back to the global sort) and a bounds launch per shard's
   window; no NaN, CFL < 1, no halo overflow; one host wait per group with
   the exchange resort (the guard's scalar), none with the global sort; 10
   more steps through each resort bitwise equal; then, on shard 1 of 2 in
   a fresh group, kernel A over the shard's rows of its window against its
   plain version at phase 4's tolerances, with its time, the plain time
   and its bound;
15. the sharded coupled path: bench_3d_rigid on 2 shards of the card, 200
   coupled steps at R=2 through rollout_coupled: after 20, the state and
   the bodies against WCSPHRigid's (com atol 1e-6, v_com and omega 1e-4,
   tests/test_parallel.py:438), launch counters (bvol, density and
   force_react per shard per substep), no NaN, CFL < 1, body shape drift
   below 1e-4, one host wait per group;
16. phase 5's demo_3d state through validate_state, checked_step (a clean
   step passes, a NaN velocity raises), StepTimer over five R=2 groups,
   and the orbit viewer (matplotlib's Agg) rendering it to a PNG; where
   matplotlib is not installed, the viewer's camera projection of the
   state alone (every particle in front of the camera, finite);
17. the rectangle decomposition (tisph_tpu_torch.parallel.ShardedWCSPHRect)
   on demo_3d, on a 2x2 and a 2x2x2 mesh whose shards all live on the one
   card: 100 steps at R=2 through bind -> rollout; after 20 the global
   state against the single-device WCSPH run (rows by their tag; the
   tolerances of phase 14, tests/test_parallel2d.py:80-84), the largest
   errors and whether they are bitwise 0; the launch counters prove, per
   shard and substep, a density and a force launch of kernel A with an
   i-row map, and per shard and group one rebuild pass and one bounds-only
   launch; no NaN, CFL < 1, no halo overflow, migration trip or dropped
   row; one R=2 group (build and substeps, one graph replay) queued behind
   the device spin without a host wait, and its build and a substep
   called eagerly, each alone; one host read per rollout call (its check
   of the live rows and the dropped rows); then on shard 1 of the 2x2, kernel
   A with the i-row map against its plain version at phase 4's
   tolerances, its time and its bound; and run_sharded --mesh2d 2x2
   --profile 20 (device operations, busy time and idle share a step);
18. the rectangle coupled path: bench_3d_rigid on a 2x2 mesh of the card,
   200 coupled steps at R=2 through rollout_coupled, held to WCSPHRigid
   after 20 as phase 15 is, launch counters (bvol, density and force_react
   with an i-row map per shard per substep), body shape drift below 1e-4,
   one host read per call;
19. the sharded linear layout: demo_3d on 2 and 4 slab shards of the card
   (ShardedWCSPH(layout="linear"), R=1), 50 steps; after 20 the global
   state against the single-device linear run (and whether it is bitwise
   equal); kernel C's launch counters (a density and a force launch over
   a row range per shard per step); then kernel C over shard 1 of 2's row
   range against its plain version, its time and its bound;
20. long runs through tools.soak (WCSPH.run, R=2, each chunk's
   particle-steps/s by the host clock between synchronisations): demo_3d
   10,000 steps in chunks of 1,000, then bench_3d_1m 2,500 in chunks of
   100; each with launch counters (a rebuild per group of each chunk, a
   density and a force launch per step), no NaN, CFL < 1, every particle
   still live; demo_3d's end-state speed and density errors printed beside
   artifacts/soak_r04.json's (the TPU soak of the same run); kernel A's
   density and force on demo_3d's end state against their plain versions
   at phase 4's tolerances, their times beside phase 5's;
21. tools.compare_resort on demo_3d, 200 steps at R=2 and at R=3 against
   R=1 (R=2 must stay below 0.5 h position RMSE), and
   tools.compare_compat on demo_2d, WCSPH 100 steps and legacy 50 (graph
   replays through csrc/legacy.cu), beside README's table; launch
   counters of both;
22. test_buoyancy's scenes through ShardedWCSPH.run_coupled, 2,000 steps
   at R=1 on one shard of the card (the light box floats above com_y
   0.27, the heavy one sinks below) and the light one on 2 slab shards,
   with launch counters; then bench_3d_rigid's 1,200 coupled steps at R=2
   through WCSPHRigid.run_coupled(check_every=400) and through
   rollout_coupled: every particle and body field bitwise equal;
23. the graph path (models.graphs: each R-group one CUDA graph replay)
   against graphs=False from the same start state, every field bitwise
   equal: demo_3d 201 steps at R=2 (100 full-group replays and a 1-step
   tail), bench_3d_rigid 200 coupled steps at R=2 (the bodies too) and
   demo_3d 100 steps at R=1 on the linear layout, with launch counts that
   count replays (a rebuild a group, each sweep a step, on both paths);
   a 200-step graph rollout of demo_3d queued behind the spin with no
   host wait; then on demo_3d, bench_3d_rigid and bench_3d_1m at R=2 both
   paths in turns (eager, graph, graph, eager): particle-steps/s, host ms
   a step to queue, the profile's device operations, busy ms and idle
   share a step, the capture's time and the memory of the first eager
   and graph group;
24. rollout_emit on one device and the rectangle decomposition's groups
   as graph replays against graphs=False from the same start, bitwise:
   bench_3d_mesh_500k 300 steps at R=2 (emissions at steps 0, 100 and
   200; the emitter counters and num_active too, against the host's
   cadence; captures no more than its keys, and none more over 300
   further steps and 3 more emissions), demo_3d on 2x2 and 2x2x2 (100
   steps; the flags and live-row counts too) and bench_3d_rigid coupled
   on 2x2 (100 steps; the bodies too), with launch counts that count
   replays equal on both paths; an emitting graph group and a 2x2 graph
   group queued behind the spin, one host read per 2x2 call; then the
   emitter scene (300 steps) and 2x2 (100) in turns, as phase 23;
25. the slab solver's groups and both decompositions' rollout_emit as
   graph replays against graphs=False from the same start, bitwise, with
   launch counts that count replays (the graph path runs the exchange
   resort and the global sort in every group, the eager loop the global
   sort only when the seam guard trips) and the seam guard's trips
   counted on the device equal to the eager loop's host count: demo_3d on
   2 and 4 slabs (100 steps at R=2; the halo flag too), on 2 slabs at R=1
   on the linear layout (50), from a shuffled start with a 128-row edge
   (20 steps: the guard trips), bench_3d_rigid coupled on 2 slabs (100;
   the bodies too), bench_3d_mesh_500k through rollout_emit on 2 slabs
   and on 2x2 (300 steps, 3 emissions; the emitter counters and the live
   rows too) and on 2x2 with an emit_frac that lets the busiest owner
   shard take one batch (its room test refuses the next); a 2-slab graph
   group queued behind the spin and no host read in a slab call, one in
   a 2x2 emitting call; the resort's branches timed alone, and a whole
   graph group (copy in, one replay, clone out); both paths in
   turns on demo_3d on 2 and 4 slabs and the emitter scene on 2 slabs and
   2x2, as phase 23; then demo_3d 10,000 steps through ShardedWCSPH.run
   on 2 slabs and ShardedWCSPHRect.run on 2x2 on the graph path (chunks
   of 250: each steering event and the captures it caused printed; no
   NaN, CFL < 1, every particle live; the 2x2 at balance_slack 2.5), the
   end states beside phase 20's.
26. the substep's row ops (csrc/pointwise.cu through ops.cuda.pointwise:
   eos_pack before the force sweep, advance after it) against their plain
   versions (ops.forces.eos_packs_plain, advance_plain), bitwise in every
   output, on demo_3d after phase 5's 252 steps, bench_3d_rigid after
   phase 7's coupled run, phase 11's emitter state mid-group (a batch
   emitted after the rebuild: fluid now, in no sweep's family) and the 2D
   golden start, each also with NaN and infinite rows in a copy of its
   inputs; their CUDA-event times against the plain sequences' on the
   same inputs, and their bytes bounds.  Every WCSPH path of phases 5-25
   counts one eos_pack and one advance launch a substep of a shard (one a
   density sweep), on the graph path and the eager loop alike.

The solvers of phases 5-13, 16, 17, 18, 20, 21, 22's WCSPHRigid and 23-25
run the graph path (the default of a CUDA WCSPH, WCSPHRigid and
WCSPHLegacy, and of a slab or rectangle whose shards share one card);
phase 13 runs the legacy solver's eager loop beside it, and the slab
solvers of phases 14, 15, 19 and 22 (graphs=False, as they ran before
phase 25 existed) run the eager loop.

Every kernel's entry in the JSON line has a bound: the larger of the bytes
it must move (each input read once, each output written once) over 3.35
TB/s and its f32 operations (pairs inside h on this run's state, times the
operations per pair counted from the CUDA source) over 67 TFLOP/s, the
H100 SXM's published peaks; and, for the bounds-only launch, the time of
torch.searchsorted on the same inputs, for the rebuild that of
torch.searchsorted plus one index_select per field (no PyTorch call
computes a sweep).  The legacy sweeps' operations count the pairs of
fluid rows inside h their sums take (fluid j for density, every live j
for force).  The row ops' bounds count each row's bytes (the density
sweep's rho on the sort-time fluid rows and the stored one elsewhere, dv
on the fluid rows) and their operations per row from the CUDA source; no
one PyTorch call computes either.

The launches in the JSON line are the sums of the main paths' runs:
phases 5, 11, 12 with 14, 15, 17, 18 and 20-25 for kernel A's density and
force, the same and 13 and 19 for kernel B, 7, 15, 18, 22-25 for bvol
and force_react, 9, 19, 23 and 25 for kernel C, 13 (demo_2d, the
per-step golden scene, demo_3d and bench_3d_1m) and 21 for the legacy
kernel's two modes (graph replays: a rebuild, a density and a force
launch a step), and for eos_pack and advance every phase of A's density
and of C's.  A's max_abs_err folds in its checks over a row range
(phase 14), with an i-row map (17) and, for density and force, on
demo_3d after 10,000 steps (20); C's over a row range (19); the legacy
kernel's its checks on four states at every lane count (13); the row
ops' their finite outputs over phase 26's states (0: bitwise).  The
legacy entries also carry the lanes their launch on demo_2d's state
takes and the rule (``lane_rule``: by dim, rows below, lanes).

The last two lines of standard output are the JSON kernel summary and
{"ok": true, "device": {...}}; any failure exits nonzero before them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEMO_3D = os.path.join(HERE, "scenes", "demo_3d.json")
DEMO_2D = os.path.join(HERE, "scenes", "demo_2d.json")
EMIT_3D = os.path.join(HERE, "scenes", "bench_3d_mesh_500k.json")
RIGID_3D = os.path.join(HERE, "scenes", "bench_3d_rigid.json")
LARGE_3D = os.path.join(HERE, "scenes", "bench_3d_1m.json")
DEVICE = "cuda"
STEPS_R2, STEPS_R1 = 200, 50
RIGID_R2, RIGID_R1 = 1500, 100
BUOYANCY_STEPS = 2000
LINEAR_STEPS = 100
LARGE_STEPS = 20
EMIT_R2, EMIT_R1 = 600, 100
CKPT_STEPS = 200
LEGACY_CHECK, LEGACY_STEPS = 20, 500
LEGACY_TURNS = 500  # phase 13: steps of each path in turns
LEGACY_PER_STEP = 100  # phase 13: the 3D golden scene with per-step volumes
# phase 13: the kernel's 3D states, demo_3d and bench_3d_1m after that many
# legacy steps; demo_3d's legacy steps of each path in turns
LEGACY_3D_STEPS, LEGACY_1M_STEPS = 252, 20
LEGACY_3D_TURNS = 200
BITWISE_STEPS = 20
SHARD_STEPS, SHARD_CHECK, SHARD_BITWISE = 100, 20, 10  # phase 14
SHARD_RIGID = 200  # phase 15
RECT_STEPS, RECT_CHECK = 100, 20  # phase 17 (and the check of 18 and 19)
RECT_RIGID = 200  # phase 18
LIN_SHARD_STEPS = 50  # phase 19
SOAK_STEPS, SOAK_CHUNK = 10_000, 1_000  # phase 20, demo_3d
SOAK_1M_STEPS, SOAK_1M_CHUNK = 2_500, 100  # phase 20, bench_3d_1m
RESORT_STEPS = 200  # phase 21
COMPAT_SUBSTEPS = 5  # phase 21: demo_2d's snapshots every 5 steps
COMPAT_STEPS = {"wcsph": 100, "legacy": 50}  # phase 21, README's table
RESORT_CHUNK = 100  # tools.compare_resort's rollouts
COUPLED_RUN, COUPLED_CHECK = 1_200, 400  # phase 22, bench_3d_rigid
# phase 23: (label, scene, layout, R, steps) of the bitwise checks; demo_3d
# at R=2 takes 100 full-group replays and a 1-step tail
GRAPH_BITWISE = (("demo_3d R=2", DEMO_3D, "seg", 2, 201),
                 ("bench_3d_rigid coupled R=2", RIGID_3D, "seg", 2, 200),
                 ("demo_3d linear R=1", DEMO_3D, "linear", 1, 100))
GRAPH_NO_WAIT = 200  # phase 23: steps of a graph rollout queued behind the spin
# phase 23: (label, scene, steps) of eager against graph in turns, at R=2
GRAPH_TURNS = (("demo_3d", DEMO_3D, 200), ("bench_3d_rigid", RIGID_3D, 200),
               ("bench_3d_1m", LARGE_3D, 40))
GRAPH_PROFILE = 20  # phases 23 and 24: profiled steps per path
# phase 24: the emitter scene at R=2 (emissions at steps 0, 100 and 200),
# and the rectangle's runs
EMIT_GRAPH_STEPS, RECT_GRAPH_STEPS = 300, 100
# phase 25: demo_3d and bench_3d_rigid on slabs at R=2, the linear layout
# at R=1, and the run from a shuffled start
SLAB_GRAPH_STEPS, SLAB_LINEAR_STEPS, SLAB_TRIP_STEPS = 100, 50, 20
SHARD_LONG_CHUNK = 250  # phase 25: run's chunk on 2 slabs and 2x2 (10,000 steps)
RECT_LONG_SLACK = 2.5  # phase 25: the 2x2 long run's balance_slack
SPIN_CYCLES = 2_000_000_000  # about a second at the H100's clocks

# tests/test_rigid_dynamics.py::test_buoyancy's pool and box
POOL = [{"start": [0.09, 0.09, 0.09], "end": [0.91, 0.45, 0.91],
         "velocity": [0, 0, 0], "density": 1000.0, "color": [50, 100, 200],
         "spacing": "diameter"}]
BOX = ((0.42, 0.5, 0.42), (0.58, 0.62, 0.58))

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

# 20^3 fluid particles at 0.63 of the radius spacing over 3^3 cells, up to
# 343 to a cell (4 times demo_3d's start): a block of 128 rows has windows
# of about 1,000 j in each of its 9 stencil rows.  Not denser: the f32 sums
# of the kernel and of the plain version, taken in different orders, part
# by about 1e-7 sqrt(pairs inside h) of max|dv|, and the tolerance is 5e-6:
# this state's force read 2.8e-6 to 3.2e-6 of max|dv| against the plain
# version on an H100 (its index_add_ sums in a varying order), a lattice at
# half the radius spacing 4.8e-6
MANY_CHUNKS = {
    "configuration": {
        "dim": 3, "domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.0, 1.0, 1.0],
        "particleRadius": 0.01, "density0": 1000,
        "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0,
    },
    "fluidBlocks": [{"start": [0.4, 0.4, 0.4], "end": [0.52, 0.52, 0.52],
                     "velocity": [0.5, -1.0, 0.25], "density": 1000.0,
                     "color": [50, 100, 200], "spacing": 0.0063}],
}

TOL = {  # (density and bvol rtol, force atol after scaling by max|force|)
    False: (2e-5, 5e-6),
    True: (2e-5, 1e-5),
}

# The H100 SXM's published peaks (NVIDIA's data sheet): device memory and
# f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per pair inside h in 3D (the bounds of kernels A and C are
# taken on 3D states only), counted from csrc/sweeps.cu (the
# linear kernel's pair code is the same): 23 to the spline value w (3
# differences, r^2 in 5, the clamp, rsqrt, q in 2, p1 and p2 in 2 each,
# their squares, w in 5), then density and bvol +2 (multiply-add into the
# sum); force +37 (gmag 4, dot 8, dot_neg 3, bdv 1, nu_f 3, visc 4, press
# 3, coef 5, the three sums 6); reaction +29 (gmag 4, dot 8, dot_neg 3,
# nu_b,j 3, coef 5, sums 6).
FLOPS_PER_PAIR = {"density": 25, "bvol": 25, "force": 60, "reaction": 52}
# the same count for csrc/legacy.cu, by dim: 10 to q in 3D, 7 in 2D (dim
# differences, r^2 in 5 or 3, sqrt, the divide by h), then density +14
# (the piecewise W in 11, fl m_V W into the sum in 3); force +43 in 3D,
# +36 in 2D (dot 8 or 5, viscosity 5, fluid pressure 4, boundary pressure
# 4, the gradient factor 7, 1 / max(r h, eps h) 3, each axis 4)
LEGACY_FLOPS_PER_PAIR = {"legacy_density": {2: 21, 3: 24}, "legacy_force": {2: 43, 3: 53}}
# csrc/pointwise.cu's two kernels, and their f32 operations counted from
# the source: eos_pack 12 a row at gamma = 7 (the clamp, the ratio, the
# power's 4 multiplies, p in 2, rho^2, its clamp and the divide; +1 for
# reference_exact's m W(0)); advance on a fluid row 10 an axis (v and x in
# 4, the normal's 2 compares and sum, its square, the clamp's 2), then
# |n| in 5 (3D; 3 in 2D) + 2, n^ and v n^ 2 an axis, v . n^ in 5 (3), the
# test and (1 + c_f) v . n^ 2, the reflection 2 an axis
ROW_OPS = ("eos_pack", "advance")
EOS_FLOPS_PER_ROW = 12
ADVANCE_FLOPS_PER_FLUID_ROW = {2: 38, 3: 56}


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


def time_against_plain(timing: dict) -> dict[str, tuple[float, float]]:
    """{name: (kernel, plain, reps, plain reps)} -> {name: (kernel ms, plain
    ms)}: plain, kernel, kernel, plain in turns within this call, means of
    each pair."""
    times = {}
    for name, (kern, plain, reps, preps) in timing.items():
        p_a = cuda_ms(plain, preps)
        k_a = cuda_ms(kern, reps)
        k_b = cuda_ms(kern, reps)
        p_b = cuda_ms(plain, preps)
        times[name] = ((k_a + k_b) / 2, (p_a + p_b) / 2)
        print(f"  time {name:<17} kernel {k_a:.4f} / {k_b:.4f} ms   "
              f"plain {p_a:.4f} / {p_b:.4f} ms")
    return times


def reset_counts(kernels) -> None:
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "part_launches"):
            k.part_launches = 0


def with_row_ops(want: dict) -> dict:
    """``want`` (launch counts) with the row ops' launches: one eos_pack
    and one advance (csrc/pointwise.cu) a density sweep of kernel A or C,
    i.e. one each a substep of a shard on every WCSPH path (none on the
    legacy solver's)."""
    n = want.get("sweep.density", 0) + want.get("linear.density", 0)
    return want | {k: n for k in ROW_OPS}


def assert_no_host_wait(label: str, fn) -> None:
    """``fn()`` must only queue device work.  It runs behind a device-side
    spin of about a second, with torch's sync debug mode set to raise on a
    synchronising call, and the spin must still be running when ``fn``
    returns: a host wait of any kind, even one torch cannot see, would
    have outlasted it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    spun = torch.cuda.Event()
    spun.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    spin_running = not spun.query()
    torch.cuda.synchronize()
    print(f"  {label}: queued in {host_ms:.3f} ms of host time, device spin still "
          f"running when it returned: {spin_running}")
    if not spin_running:
        raise AssertionError(f"{label}: the host waited for the device")


def sweep_inputs(solver, state, per_step: bool = False):
    """Sorted state and the sweep packs of one substep's density and force
    calls (density and the packs from the plain versions, so both sides of
    every comparison read identical inputs).  ``per_step``: boundary volumes
    from a bvol pass on the current positions first, as the coupled
    substep takes them."""
    from tisph_tpu_torch.models.wcsph import group_masses, per_step_volumes
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.forces import eos_packs_plain as eos_packs
    from tisph_tpu_torch.ops.grid import csr_bounds, sort_state_by_cell

    spec, params = solver.spec, solver.params
    st, ids, _ = sort_state_by_cell(state, spec)
    bounds = csr_bounds(ids, spec)
    fl, bd = st.fluid_mask, st.boundary_mask
    pos_b = neighbors.pack4(st.x, bd.to(torch.float32))
    flm, effm = group_masses(st, fl, bd, params.density0)
    if per_step:
        delta = neighbors.bvol_sweep(pos_b, ids, bounds, st.material, spec, params)
        vol, effm = per_step_volumes(delta, bd, st.volume, flm, params.density0)
        st = dataclasses.replace(st, volume=vol)
    pos = neighbors.pack4(st.x, effm)
    rho = neighbors.density_sweep(pos, ids, bounds, st.material, spec, params)
    _, _, vel, aux = eos_packs(rho, st, fl, flm, params)
    return {"st": st, "ids": ids, "bounds": bounds, "pos": pos, "pos_b": pos_b,
            "vel": vel, "aux": aux}


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

        def run():
            return {
                "density": sweeps.density_sweep(inp["pos"], ids, bounds, mat, spec, params,
                                                fast),
                "bvol": sweeps.bvol_sweep(inp["pos_b"], ids, bounds, mat, spec, params, fast),
                "force": sweeps.force_sweep(inp["pos"], inp["vel"], inp["aux"], ids, bounds,
                                            mat, spec, params, fast),
            }

        got, again = run(), run()
        torch.cuda.synchronize()
        for mode, rows in (("density", fl), ("bvol", bd), ("force", fl)):
            g, r = got[mode], ref[mode]
            if not torch.equal(g, again[mode]):
                raise AssertionError(f"{label} {mode} fast={fast}: two calls on the same "
                                     "input differ")
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


def check_coupling_sweeps(label: str, solver, inp) -> dict[str, float]:
    """Kernel vs plain for force_react and reaction at both fast_math
    settings: fluid rows at the force tolerance scaled by max|dv|,
    boundary rows at the same bounds scaled by max|reaction|, exact 0 on
    every other row; returns the max abs error per mode at fast_math on."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import sweeps

    spec, params = solver.spec, solver.params
    st, ids, bounds, mat = inp["st"], inp["ids"], inp["bounds"], inp["st"].material
    fl, bd = st.fluid_mask, st.boundary_mask
    args = (inp["pos"], inp["vel"], inp["aux"], ids, bounds, mat, spec, params)
    ref = {"force_react": neighbors.force_react_sweep(*args),
           "reaction": neighbors.reaction_sweep(*args)}
    errs = {}
    for fast in (False, True):
        atol = TOL[fast][1]
        got, again = ({"force_react": sweeps.force_react_sweep(*args, fast),
                       "reaction": sweeps.reaction_sweep(*args, fast)} for _ in range(2))
        torch.cuda.synchronize()
        for mode, fams in (("force_react", (("fluid", fl), ("boundary", bd))),
                           ("reaction", (("boundary", bd),))):
            g, r = got[mode], ref[mode]
            if not torch.equal(g, again[mode]):
                raise AssertionError(f"{label} {mode} fast={fast}: two calls on the same "
                                     "input differ")
            fam = torch.zeros_like(fl)
            for _, rows in fams:
                fam = fam | rows
            if not torch.isfinite(g).all():
                raise AssertionError(f"{label} {mode} fast={fast}: non-finite output")
            if not torch.equal(g[~fam], torch.zeros_like(g[~fam])):
                raise AssertionError(f"{label} {mode}: rows outside its family not 0")
            for fam_name, rows in fams:
                if not bool(rows.any()):
                    raise AssertionError(f"{label}: no {fam_name} rows")
                scale = float(r[rows].abs().max())
                if not scale > 0.0:
                    raise AssertionError(f"{label} {mode}: {fam_name} rows all 0")
                err = float((g[rows] - r[rows]).abs().max())
                rel = err / scale
                print(f"  {label:<12} {mode:<11} {fam_name:<8} fast_math={int(fast)} "
                      f"rows={int(rows.sum())} max|ref|={scale:.4e} max|err|={err:.3e} "
                      f"max|err|/max|ref| = {rel:.3e} (atol {atol})")
                if rel > atol:
                    raise AssertionError(f"{label} {mode} {fam_name} fast={fast}: "
                                         f"{rel:.3e} > {atol}")
            if fast:
                errs[mode] = float((g - r).abs().max())
    return errs


def linear_chunks() -> dict[str, int]:
    """The linear kernel's chunk capacities, j per shared-memory chunk in
    its density and force modes, read from its source."""
    with open(os.path.join(HERE, "tisph_tpu_torch", "csrc", "sweeps_linear.cu")) as f:
        src = f.read()
    return {m: int(re.search(rf"constexpr int kChunk{m.capitalize()} = (\d+);", src).group(1))
            for m in ("density", "force")}


def check_linear_sweeps(label: str, solver, inp, min_chunks: int = 0) -> dict[str, float]:
    """The linear kernel against its plain version and against the seg
    kernel (the same function) at both fast_math settings, at phase 4's
    tolerances, its density bitwise equal to the seg kernel's where that
    runs one thread per row (its sums in j order too); its block windows
    against grid.block_window_bounds exactly; the largest block
    stream must fill at least ``min_chunks`` chunks.  Returns the max abs
    error against the plain version at fast_math on, per mode."""
    from tisph_tpu_torch.ops import grid, neighbors
    from tisph_tpu_torch.ops.cuda import sweeps

    spec, params = solver.spec, solver.params
    st, ids, bounds, mat = inp["st"], inp["ids"], inp["bounds"], inp["st"].material
    fl = st.fluid_mask
    d_args = (inp["pos"], ids, bounds, mat, spec, params)
    f_args = (inp["pos"], inp["vel"], inp["aux"], ids, bounds, mat, spec, params)
    plain = {"density": neighbors.density_sweep_linear(*d_args),
             "force": neighbors.force_sweep_linear(*f_args)}
    windows = torch.empty((-(-ids.shape[0] // neighbors.LINEAR_BLOCK), spec.num_rows, 2),
                          dtype=torch.int32, device=DEVICE)
    seg_lanes = sweeps.launch_shape("density", ids.shape[0])[0]
    errs = {}
    for fast in (False, True):
        rtol, atol_f = TOL[fast]
        got = {"density": sweeps.density_sweep_linear(*d_args, fast, windows=windows),
               "force": sweeps.force_sweep_linear(*f_args, fast)}
        seg = {"density": sweeps.density_sweep(*d_args, fast),
               "force": sweeps.force_sweep(*f_args, fast)}
        torch.cuda.synchronize()
        for mode in ("density", "force"):
            g = got[mode]
            if not torch.isfinite(g).all():
                raise AssertionError(f"{label} linear {mode} fast={fast}: non-finite output")
            if not torch.equal(g[~fl], torch.zeros_like(g[~fl])):
                raise AssertionError(f"{label} linear {mode}: rows off the fluid not 0")
            for ref_name, r in (("plain", plain[mode]), ("seg kernel", seg[mode])):
                err = float((g - r).abs().max())
                if mode == "force":
                    rel = err / float(r[fl].abs().max())
                    ok, tol = rel <= atol_f, f"max|err|/max|ref| = {rel:.3e} (atol {atol_f})"
                else:
                    rel = float(((g - r)[fl].abs() / r[fl].abs().clamp(min=1e-30)).max())
                    ok, tol = rel <= rtol, f"max rel err = {rel:.3e} (rtol {rtol})"
                print(f"  {label:<12} linear {mode:<8} vs {ref_name:<10} fast_math={int(fast)} "
                      f"rows={int(fl.sum())} max|err|={err:.3e} {tol}")
                if not ok:
                    raise AssertionError(f"{label} linear {mode} vs {ref_name} fast={fast}: {tol}")
                if fast and ref_name == "plain":
                    errs[mode] = err
        # the same terms in the same order as the seg kernel's one-lane walk
        if seg_lanes == 1 and not torch.equal(got["density"], seg["density"]):
            raise AssertionError(f"{label} linear density fast={fast}: not bitwise equal to "
                                 "the seg kernel's")
    lo, hi = grid.block_window_bounds(ids, grid.coords_from_ids(ids, spec), spec,
                                      neighbors.LINEAR_BLOCK)
    if not torch.equal(windows, torch.stack([lo, hi], dim=-1)):
        raise AssertionError(f"{label}: the kernel's block windows != block_window_bounds")
    # candidates: the j each block loads (its windows) against the j each
    # row of the seg kernel walks (its stencil runs)
    per_block = (hi - lo).clamp(min=0).sum(dim=1).double()
    runs = grid.stencil_runs(grid.coords_from_ids(ids[fl], spec), bounds, spec).double()
    per_row = (runs[..., 1] - runs[..., 0]).sum(dim=1)
    chunks = linear_chunks()
    largest = float(per_block.max())
    print(f"  {label}: density " + ("bitwise equal to the seg kernel's" if seg_lanes == 1 else
          f"within rtol of the seg kernel's ({seg_lanes} lanes per row there)")
          + "; block windows equal "
          f"block_window_bounds ({lo.numel()} windows); "
          f"candidates per block of 128 rows: mean {float(per_block.mean()):.1f}, max "
          f"{float(per_block.max()):.0f}, total {float(per_block.sum()):.0f}; per fluid row "
          f"of the seg kernel: mean {float(per_row.mean()):.1f}, total {float(per_row.sum()):.0f}; "
          f"largest block stream {largest:.0f} j = " + ", ".join(
              f"{largest / c:.2f} chunks of {c} ({m})" for m, c in chunks.items()))
    if largest < min_chunks * max(chunks.values()):
        raise AssertionError(f"{label}: largest block stream {largest:.0f} j fills fewer "
                             f"than {min_chunks} chunks of {max(chunks.values())}")
    return errs


def pairs_inside_h(inp, solver, rows, cols) -> int:
    """#(i, j) with i in ``rows``, j in ``cols`` and r_ij < h, self pairs
    included: the pairs whose terms a sweep of those rows must compute."""
    from tisph_tpu_torch.ops import neighbors

    x, h2 = inp["st"].x, solver.params.support_length ** 2
    total = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for i, j in neighbors.candidates(inp["ids"], inp["bounds"],
                                     torch.nonzero(rows).squeeze(1), solver.spec):
        d = x[i] - x[j]
        total += ((torch.sum(d * d, dim=1) < h2) & cols[j]).sum()
    return int(total)


def sweep_bound(mode: str, inp, solver, seg: bool = True) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations") of one sweep call on ``inp``:
    bytes = the packs it reads (pos; vel and aux in the gradient modes),
    ids, material, the CSR bounds and its output; operations = its pairs
    inside h times FLOPS_PER_PAIR (the reaction rows of force_react at the
    reaction's count).  Prints beside it what the walk meets on this state:
    the candidates per consumer row (the j of its stencil runs), the pairs
    inside h per row (those that carry weight in this mode) and their
    ratio, and, for a seg sweep, the launch shape the wrapper chooses."""
    from tisph_tpu_torch.ops import grid
    from tisph_tpu_torch.ops.cuda import sweeps

    st = inp["st"]
    n, dim, nc = st.capacity, solver.spec.dim, solver.spec.num_cells
    if dim != 3:
        raise AssertionError(f"FLOPS_PER_PAIR counts 3D pairs, the state is {dim}D")
    fl, bd = st.fluid_mask, st.boundary_mask
    act = st.active_mask
    grad = mode in ("force", "force_react", "reaction")
    nbytes = n * (16 + 4 + 4) + (nc + 1) * 4 + (2 * n * 16 + n * dim * 4 if grad else n * 4)
    # (consumer rows, the j that carry weight, operations per pair)
    terms = {
        "density": [(fl, act, FLOPS_PER_PAIR["density"])],
        "bvol": [(bd, bd, FLOPS_PER_PAIR["bvol"])],  # only boundary j carry weight
        "force": [(fl, act, FLOPS_PER_PAIR["force"])],
        "reaction": [(bd, fl, FLOPS_PER_PAIR["reaction"])],  # only fluid j carry weight
        "force_react": [(fl, act, FLOPS_PER_PAIR["force"]),
                        (bd, fl, FLOPS_PER_PAIR["reaction"])],
    }[mode]
    pairs = [pairs_inside_h(inp, solver, rows, cols) for rows, cols, _ in terms]
    flops = sum(k * f for k, (_, _, f) in zip(pairs, terms))
    rows = terms[0][0] if len(terms) == 1 else terms[0][0] | terms[1][0]
    n_rows = int(rows.sum())
    runs = grid.stencil_runs(grid.coords_from_ids(inp["ids"][rows], solver.spec),
                             inp["bounds"], solver.spec).long()
    cand = int((runs[..., 1] - runs[..., 0]).clamp(min=0).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    shape = ""
    if seg:
        lanes, ctas = sweeps.launch_shape(mode, n)
        shape = f"; launch: {lanes} thread(s) per row, {ctas} CTAs of 128 for {n} rows"
    print(f"  bound {mode:<12} {nbytes / 1e6:.3f} MB -> {t_bytes * 1e3:.5f} ms, "
          f"{flops / 1e9:.4f} GFLOP -> {t_ops * 1e3:.5f} ms; {n_rows} consumer rows, "
          f"{cand / max(n_rows, 1):.1f} candidates and {sum(pairs) / max(n_rows, 1):.1f} pairs "
          f"inside h per row ({sum(pairs) / max(cand, 1):.3f} of the candidates){shape}")
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def body_drift(state, rigid, tags, d0) -> float:
    """max | |x_p - com| - d0 | over the particles of body 0, matched by
    their tag in color[:, 0] (the sort moves rows, the colour goes with
    them)."""
    sel = (state.object_id == int(rigid.object_ids[0])) & state.boundary_mask
    x = state.x[sel][torch.argsort(state.color[sel, 0])]
    if not torch.equal(torch.sort(state.color[sel, 0]).values, tags):
        raise AssertionError("body particles lost or duplicated")
    d = torch.linalg.vector_norm(x - rigid.com[0], dim=1)
    return float((d - d0).abs().max())


def pool_scene(tt, density: float, tmp: str):
    """test_buoyancy's scene: a box of ``density`` over a calm pool."""
    from tisph_tpu_torch.geometry.mesh import box_mesh, save_obj

    save_obj(box_mesh(*BOX), os.path.join(tmp, "box.obj"))
    raw = {
        "configuration": {"dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
                          "particleRadius": 0.02, "density0": 1000,
                          "gravitation": [0.0, -9.81, 0.0], "c_s": 40.0},
        "rigidBodies": [{"geometryFile": "box.obj", "scale": [1, 1, 1],
                         "translation": [0, 0, 0], "rotationAngle": 0,
                         "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
                         "density": density, "color": [150, 150, 150], "isDynamic": True}],
        "fluidBlocks": POOL,
    }
    return tt.scene_from_dict(raw, base_dir=tmp)


def buoyancy(tt, density: float, tmp: str) -> float:
    """test_buoyancy's scene with a box of ``density``: com_y after
    BUOYANCY_STEPS coupled steps at R=1, on the card."""
    scene = pool_scene(tt, density, tmp)
    solver, state, rigid = tt.make_solver(scene, tt.build_state(scene, device=DEVICE),
                                          device=DEVICE, resort_every=1)
    t0 = time.perf_counter()
    state, rigid = solver.rollout_coupled(state, rigid, BUOYANCY_STEPS)
    com = rigid.com[0].tolist()
    wall = time.perf_counter() - t0
    m = solver.metrics(state)
    print(f"  density {density:g}: {state.num_active} particles, com after "
          f"{BUOYANCY_STEPS} steps ({BUOYANCY_STEPS * solver.params.dt:.2f} s) = "
          f"{com}, {wall * 1e3 / BUOYANCY_STEPS:.4f} ms/step, metrics {m}")
    if m["nan_count"] or not all(math.isfinite(c) for c in com):
        raise AssertionError(f"buoyancy density {density}: non-finite state")
    return com[1]


def golden_check(tt, name: str, raw: dict, steps: int, fast_math: bool,
                 layout: str = "seg") -> dict:
    """Run a golden scene at R=1 on ``layout``'s sweeps and match its
    particles to the recorded ones.  The recording is ordered by position,
    and a 1-ulp difference
    reorders particles with equal coordinates, so each particle is matched
    to the recorded one of least cost max(|dx|/5e-5, |dv|/5e-2,
    |drho|/(5e-4 rho)) (test_golden's tolerances): the run reproduces the
    golden iff that matching is one to one with every cost <= 1."""
    scene = tt.scene_from_dict(raw)
    solver = tt.WCSPH(scene, device=DEVICE, resort_every=1, fast_math=fast_math,
                      layout=layout)
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
    print(f"  golden {name} layout={layout} fast_math={int(fast_math)}: "
          f"{len(got['x'])} particles, "
          f"one to one {one_to_one}, materials equal {same_mat}, "
          f"worst cost {worst:.4f} (<= 1 passes)")
    return {"ok": one_to_one and same_mat and worst <= 1.0, "worst": worst}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's words as int32, so that equality is bitwise."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def check_rebuild(label: str, state, spec, min_largest: int = 0) -> float:
    """The rebuild kernel (sort_and_bound) against its plain version
    (sort_state_by_cell, csr_bounds) on ``state``: every field, the sorted
    ids, the permutation and the bounds must be equal bit for bit, and the
    largest cell must hold at least ``min_largest`` ids.  Returns the max
    abs difference (0.0)."""
    from tisph_tpu_torch.ops import grid as gridops
    from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds

    before = cuda_bounds.sort_and_bound.launches
    st, ids, perm, bounds = cuda_bounds.sort_and_bound(state, spec)
    p_st, p_ids, p_perm = gridops.sort_state_by_cell(state, spec)
    p_bounds = gridops.csr_bounds(p_ids, spec)
    torch.cuda.synchronize()
    if cuda_bounds.sort_and_bound.launches != before + 1:
        raise AssertionError(f"rebuild {label}: the kernel did not launch once")
    pairs = [("ids", ids, p_ids), ("perm", perm, p_perm), ("bounds", bounds, p_bounds)]
    pairs += [(k, getattr(st, k), getattr(p_st, k)) for k in gridops.state_fields(st)]
    err = 0.0
    for name, got, want in pairs:
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(
                _bits(got), _bits(want)):
            raise AssertionError(f"rebuild {label}: {name} differs from the plain version")
        if got.numel():
            err = max(err, float((got.double() - want.double()).abs().max()))
    n, nc = state.capacity, spec.num_cells
    active = int(state.active_mask.sum())
    words = sum(getattr(st, k)[:1].numel() for k in gridops.state_fields(st))
    largest = int(torch.diff(bounds[:-1]).max()) if nc > 1 else int(bounds[-1])
    print(f"  rebuild {label}: {n} rows ({active} active, {n - active} "
          f"inactive), {words} words a row, {nc + 1} cells, largest cell {largest} ids "
          f"(a bounds CTA holds {cuda_bounds.ITEMS_PER_CTA}): every field, ids, perm and "
          "bounds bitwise equal")
    if largest < min_largest:
        raise AssertionError(f"rebuild {label}: largest cell {largest} < {min_largest} ids")
    return err


def rebuild_bound(state, spec) -> tuple[float, str]:
    """The rebuild pass's least time: each row's words read and written
    once, its perm (8 B) and id (4 B) read, the bounds written, over the
    card's memory rate (its work is integer compares)."""
    from tisph_tpu_torch.ops import grid as gridops

    words = sum(getattr(state, k)[:1].numel() for k in gridops.state_fields(state))
    nbytes = state.capacity * (2 * 4 * words + 8 + 4) + (spec.num_cells + 1) * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def rebuild_times(label: str, state, spec, reps: int = 100) -> dict[str, float]:
    """Device times of the rebuild pass after the sort on ``state``: the
    kernel (gather_and_bound), its plain version (gather_state, csr_bounds),
    the library calls of the same work (torch.searchsorted, then one
    index_select per field), the bounds-only launch, and the whole rebuild
    with the cell ids and the sort (sort_and_bound, and the plain
    sort_state_by_cell plus csr_bounds); beside them the bytes' bound."""
    from tisph_tpu_torch.ops import grid as gridops
    from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds

    ids = gridops.flat_cell_ids(gridops.cell_coords(state.x, spec), state.material, spec)
    sorted_ids, perm = torch.sort(ids, stable=True)
    names = gridops.state_fields(state)
    queries = torch.arange(spec.num_cells + 1, dtype=torch.int32, device=DEVICE)
    fields = [getattr(state, k) for k in names]
    t = time_against_plain({
        f"rebuild@{label}": (lambda: cuda_bounds.gather_and_bound(state, sorted_ids, perm, spec),
                             lambda: (gridops.gather_state(state, perm),
                                      gridops.csr_bounds(sorted_ids, spec)), reps, reps),
        f"bounds@{label}": (lambda: cuda_bounds.csr_bounds_sorted(sorted_ids, spec),
                            lambda: gridops.csr_bounds(sorted_ids, spec), reps, reps),
        f"sort+rebuild@{label}": (lambda: cuda_bounds.sort_and_bound(state, spec),
                                  lambda: (gridops.csr_bounds(
                                      gridops.sort_state_by_cell(state, spec)[1], spec)),
                                  reps, reps),
    })
    search = cuda_ms(lambda: torch.searchsorted(sorted_ids, queries, out_int32=True), reps)
    selects = cuda_ms(lambda: [f.index_select(0, perm) for f in fields], reps)
    library = cuda_ms(lambda: (torch.searchsorted(sorted_ids, queries, out_int32=True),
                               [f.index_select(0, perm) for f in fields]), reps)
    bound, _ = rebuild_bound(state, spec)
    kern = t[f"rebuild@{label}"][0]
    print(f"  rebuild@{label}: kernel {kern:.4f} ms, plain {t[f'rebuild@{label}'][1]:.4f} ms, "
          f"library {library:.4f} ms (torch.searchsorted {search:.4f} + {len(fields)} "
          f"index_selects {selects:.4f}), bound {bound:.5f} ms by bytes "
          f"({bound / kern:.3f} of it); bounds-only launch {t[f'bounds@{label}'][0]:.4f} ms")
    return {"ms": kern, "plain_ms": t[f"rebuild@{label}"][1], "library_ms": library,
            "searchsorted_ms": search, "index_selects_ms": selects,
            "bounds_ms": t[f"bounds@{label}"][0], "bounds_plain_ms": t[f"bounds@{label}"][1],
            "bound_ms": bound}


def plain_rebuild_rollout(solver, state, steps: int):
    """``steps`` substeps in groups of ``solver.resort_every``, each group
    built from the plain rebuild (sort_state_by_cell, csr_bounds) and the
    solver's own _group_cache and _apply: what rollout does, with the
    rebuild kernel's plain version in its place."""
    from tisph_tpu_torch.ops import grid as gridops

    done = 0
    while done < steps:
        state, ids, _ = gridops.sort_state_by_cell(state, solver.spec)
        cache = solver._group_cache(state, ids, gridops.csr_bounds(ids, solver.spec))
        k = min(solver.resort_every, steps - done)
        for _ in range(k):
            state = solver._apply(state, cache)
        done += k
    return state


def group_inputs(solver, state, cache):
    """The sweep packs of ``solver._apply``'s density and force calls on
    ``state`` inside the R-group of ``cache``, whose sort-time ids, bounds
    and material the sweeps take (density from the plain version): the
    counterpart of sweep_inputs for a state that an emitter changed after
    the group's rebuild.  ``st`` carries the sort-time material, so a
    checker's family rows are the rebuild's."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.forces import eos_packs_plain as eos_packs

    spec, params = solver.spec, solver.params
    ids, bounds = cache.ids, cache.bounds
    pos = neighbors.pack4(state.x, cache.effm)
    rho = neighbors.density_sweep(pos, ids, bounds, cache.material, spec, params)
    _, _, vel, aux = eos_packs(rho, state, cache.fluid, cache.flm, params)
    return {
        "st": dataclasses.replace(state, material=cache.material), "ids": ids, "bounds": bounds,
        "pos": pos, "pos_b": neighbors.pack4(state.x, cache.boundary.to(torch.float32)),
        "vel": vel, "aux": aux,
    }


def emission_cadence(es, num_active: int, capacity: int, steps: int) -> tuple[int, int]:
    """(num_active, emitted) after ``steps`` more solver steps of the
    emitter ``es``, counted on the host from its parameters: a batch fires
    on a due step when the pool holds it and the quota allows it."""
    b, emitted = es.batch_size, es.emitted
    for step in range(es.step, es.step + steps):
        if (step % es.interval == 0 and num_active + b <= capacity
                and (es.max_particles <= 0 or emitted + b <= es.max_particles)):
            num_active, emitted = num_active + b, emitted + b
    return num_active, emitted


def plain_apply(solver, state, cache):
    """``solver._apply`` with the plain sweeps (ops.neighbors) and row ops
    (ops.forces) in the place of the kernels: the same code path, the
    kernels' plain versions."""
    from unittest import mock

    from tisph_tpu_torch.ops import forces, neighbors
    from tisph_tpu_torch.ops.cuda import pointwise, sweeps

    with mock.patch.multiple(sweeps, density_sweep=neighbors.density_sweep,
                             force_sweep=neighbors.force_sweep,
                             bvol_sweep=neighbors.bvol_sweep), mock.patch.multiple(
            pointwise, eos_pack=forces.eos_packs_plain, advance=forces.advance_plain):
        return solver._apply(state, cache)


def tagged(state):
    """``state`` with each row's tag (its row number, exact in f32 below
    2^24) in color[:, 0]: colour plays no part in the physics, and the tag
    follows a row through every sort."""
    tags = torch.arange(state.capacity, dtype=torch.float32, device=state.device)
    return dataclasses.replace(state, color=torch.cat([tags[:, None], state.color[:, 1:]], 1))


def hold_to_single(label: str, got, want) -> tuple[float, float, float]:
    """A sharded run's global state against the single-device run's, live
    rows matched by their tag: material equal, x max|err| < 1e-5, v within
    atol 5e-3, density within rtol 1e-4 (tests/test_parallel.py:66-71);
    returns the three errors."""
    def by_tag(st):
        n = st.num_active
        order = torch.argsort(st.color[:n, 0])
        return [getattr(st, k)[:n][order] for k in ("color", "material", "x", "v", "density")]

    (gc, gm, gx, gv, gr), (wc, wm, wx, wv, wr) = by_tag(got), by_tag(want)
    if not (torch.equal(gc[:, 0], wc[:, 0]) and torch.equal(gm, wm)):
        raise AssertionError(f"{label}: rows or materials differ from the single-device run")
    dx = float((gx - wx).abs().max())
    dv = float((gv - wv).abs().max())
    drho = float(((gr - wr).abs() / wr.abs().clamp(min=1e-30)).max())
    print(f"  {label} vs the single-device run: x max|err| {dx:.3e} (< 1e-5), v {dv:.3e} "
          f"(5e-3), density rel {drho:.3e} (1e-4)")
    if not (dx < 1e-5 and dv <= 5e-3 and drho <= 1e-4):
        raise AssertionError(f"{label}: outside tests/test_parallel.py's tolerances")
    return dx, dv, drho


def count_host_waits(fn) -> int:
    """How many times ``fn()`` made the host wait for the device: torch's
    sync debug mode warns once per synchronising call."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def shard_sweep_inputs(sh, shards, s: int):
    """Shard s's density and force sweep inputs of one substep inside a
    fresh R-group of the sharded solver ``sh``, as its _apply forms them:
    the window's packs (density from the plain version), ids, bounds and
    sort-time material, and the shard's row range."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.forces import eos_packs_plain as eos_packs

    spec, params = sh.spec, sh.params
    shards, caches = sh._build(shards)
    c = caches[s]
    pos = [neighbors.pack4(st.x, cc.effm) for st, cc in zip(shards, caches)]
    vel, aux = [], []
    for t, (st, cc) in enumerate(zip(shards, caches)):
        rho = neighbors.density_sweep(sh._extend(pos, t), cc.ids, cc.bounds, cc.material, spec,
                                      params, rows=cc.rows)
        _, _, v, a = eos_packs(rho, st, cc.fluid, cc.flm, params)
        vel.append(v)
        aux.append(a)
    return {"pos": sh._extend(pos, s), "vel": sh._extend(vel, s), "aux": sh._extend(aux, s),
            "ids": c.ids, "bounds": c.bounds, "material": c.material, "rows": c.rows,
            "fluid": c.fluid, "x": sh._extend([st.x for st in shards], s)}


def rect_sweep_inputs(sh, shards, s: int):
    """Shard s's density and force sweep inputs of one substep inside a
    fresh R-group of the rectangle solver ``sh``, as its _apply forms them:
    the extended packs (density from the plain version), ids, bounds and
    sort-time material, and the own rows' i-row map."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.forces import eos_packs_plain as eos_packs

    spec, params = sh.spec, sh.params
    shards, caches = sh._build(shards)
    pos = sh._halo([neighbors.pack4(st.x, c.effm) for st, c in zip(shards, caches)], caches)
    vel, aux = [], []
    for t, (st, c) in enumerate(zip(shards, caches)):
        rho = neighbors.density_sweep(pos[t], c.ids, c.bounds, c.material, spec, params,
                                      rows=c.rows)
        _, _, v, a = eos_packs(rho, st, c.fluid, c.flm, params)
        vel.append(v)
        aux.append(a)
    c = caches[s]
    return {"pos": pos[s], "vel": sh._halo(vel, caches)[s], "aux": sh._halo(aux, caches)[s],
            "ids": c.ids, "bounds": c.bounds, "material": c.material, "rows": c.rows,
            "fluid": c.fluid, "x": sh._halo([st.x for st in shards], caches)[s]}


def check_shard_sweeps(label: str, sh, inp, linear: bool = False) -> dict[str, tuple]:
    """Kernel A (C with ``linear``) over the shard's rows (a row range, or
    for A an i-row map) against its plain version on the same rows at
    phase 4's tolerances (fast_math on, the main path's), rows off the
    family exactly 0; then its time against the plain version's and its
    bound.  Returns {mode: (max_abs_err, ms, plain_ms, bound_ms,
    bound_by)}."""
    from types import SimpleNamespace

    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import sweeps

    spec, params = sh.spec, sh.params
    if spec.dim != 3:
        raise AssertionError(f"FLOPS_PER_PAIR counts 3D pairs, the state is {spec.dim}D")
    rows = inp["rows"]
    row_map = isinstance(rows, torch.Tensor)
    n = rows.shape[0] if row_map else rows[1]
    w = inp["ids"].shape[0]
    fl = inp["fluid"]
    base = (inp["ids"], inp["bounds"], inp["material"], spec, params)
    args = {"density": (inp["pos"], *base),
            "force": (inp["pos"], inp["vel"], inp["aux"], *base)}
    rtol, atol_f = TOL[True]
    suffix = "_linear" if linear else ""
    out = {}
    for mode, a in args.items():
        kern = getattr(sweeps, f"{mode}_sweep{suffix}")
        plain = getattr(neighbors, f"{mode}_sweep{suffix}")
        got, again = kern(*a, True, rows=rows), kern(*a, True, rows=rows)
        ref = plain(*a, rows=rows)
        torch.cuda.synchronize()
        if not torch.equal(got, again) or not torch.isfinite(got).all():
            raise AssertionError(f"{label} {mode}: two calls differ or non-finite output")
        if not torch.equal(got[~fl], torch.zeros_like(got[~fl])):
            raise AssertionError(f"{label} {mode}: rows outside its family not 0")
        err = float((got - ref).abs().max())
        if mode == "force":
            rel = err / float(ref[fl].abs().max())
            ok, detail = rel <= atol_f, f"max|err|/max|ref| = {rel:.3e} (atol {atol_f})"
        else:
            rel = float(((got - ref)[fl].abs() / ref[fl].abs().clamp(min=1e-30)).max())
            ok, detail = rel <= rtol, f"max rel err = {rel:.3e} (rtol {rtol})"
        what = (f"{n} own rows by an i-row map" if row_map else
                f"rows [{rows[0]}, {rows[0] + n})") + f" of a {w}-row extended array"
        shape = ("blocks of 128 rows, one thread each" if linear else
                 "{} lane(s) per row, {} CTAs".format(*sweeps.launch_shape(mode, n)))
        print(f"  {label} {mode:<7} {what}, {shape}: max|err|={err:.3e} {detail}")
        if not ok:
            raise AssertionError(f"{label} {mode}: {detail}")
        ms, plain_ms = time_against_plain({f"{mode}@shard": (
            lambda: kern(*a, True, rows=rows), lambda: plain(*a, rows=rows),
            20, 2)})[f"{mode}@shard"]
        # bound: the packs over the extended array and the bounds read
        # once, ids and material (and an i-row map) of the swept rows only
        # (the kernel reads them at i), the rows' output written once; the
        # pairs inside h of the shard's fluid rows
        grad = mode == "force"
        nbytes = (w * 16 + n * (4 + 4 + (4 if row_map else 0)) + (spec.num_cells + 1) * 4
                  + (2 * w * 16 + n * spec.dim * 4 if grad else n * 4))
        rows_mask = torch.zeros(w, dtype=torch.bool, device=fl.device)
        if row_map:
            rows_mask[rows.long()] = fl
        else:
            rows_mask[rows[0]:rows[0] + n] = fl
        pairs = pairs_inside_h({"st": SimpleNamespace(x=inp["x"]), "ids": inp["ids"],
                                "bounds": inp["bounds"]}, sh, rows_mask, inp["material"] != -1)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = pairs * FLOPS_PER_PAIR[mode] / F32_FLOPS
        print(f"  bound {mode} on the shard: {nbytes / 1e6:.3f} MB -> {t_bytes * 1e3:.5f} ms, "
              f"{pairs} pairs inside h -> {t_ops * 1e3:.5f} ms")
        out[mode] = (err, ms, plain_ms, max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def sharded_demo(tt, kernels, scene, card_line: str):
    """Phase 14: ``scene`` on 2 and 4 shards of one card; returns the launch
    counts of both runs added and kernel A's checks on a shard's rows."""
    from tisph_tpu_torch.ops import grid as gridops
    from tisph_tpu_torch.parallel import ShardedWCSPH, make_mesh

    print("  every shard on the one card: particle-steps/s here is what the exchange costs, "
          "not any scaling")
    sh_start = tagged(tt.build_state(scene, device=DEVICE))
    ref_solver = tt.WCSPH(scene, device=DEVICE, resort_every=2)
    ref_check = ref_solver.rollout(ref_solver.bind(sh_start), SHARD_CHECK)
    sharded = {}
    for d in (2, 4):
        sh = ShardedWCSPH(scene, make_mesh(devices=[DEVICE] * d), resort_every=2, graphs=False)
        shards = sh.bind(sh_start)
        windows = [sh._window(s) for s in range(d)]
        print(f"  {d} shards of {sh.shard_rows} rows on {[str(x) for x in sh.mesh.devices]}: "
              f"halo {sh.halo} rows ({sh.halo_path}), exchange edge {sh.resort_edge} rows, "
              f"windows {[b - a for a, b in windows]} rows")
        reset_counts(kernels)
        sh.occ_resort.zero_()
        shards = sh.rollout(shards, SHARD_CHECK)
        hold_to_single(f"{d} shards, {SHARD_CHECK} steps", sh.gather_state(shards), ref_check)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = sh.rollout(shards, SHARD_STEPS - SHARD_CHECK)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        s_launches = {k: f.launches for k, f in kernels.items()}
        groups, fb = SHARD_STEPS // 2, int(sh.occ_resort)
        s_want = {k: 0 for k in kernels} | {
            "rebuild": (groups - fb) * d + fb, "csr_bounds": groups * d,
            "sweep.density": SHARD_STEPS * d, "sweep.force": SHARD_STEPS * d}
        s_want = with_row_ops(s_want)
        if s_launches != s_want:
            raise AssertionError(f"{d} shards: launch counts {s_launches}, expected {s_want}")
        m = sh.metrics(shards)
        print(f"  launches: {s_launches} ({groups} groups, {fb} seam-guard fallbacks to the "
              f"global sort: rebuild d per exchange group, 1 per fallback)")
        print(f"  metrics: {m}")
        if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
            raise AssertionError(f"{d} shards unhealthy: {m}")
        if m["occ_halo"]:
            raise AssertionError(f"{d} shards: a window missed a stencil (halo {sh.halo})")
        waits = count_host_waits(lambda: sh.rollout(shards, 2))
        sh.resort = "global"
        g_waits = count_host_waits(lambda: sh.rollout(shards, 2))
        sh.resort = "exchange"
        print(f"  host waits per R=2 group: {waits} with the exchange resort (its seam guard), "
              f"{g_waits} with the global sort")
        if waits != 1 or g_waits != 0:
            raise AssertionError(f"{d} shards: {waits} / {g_waits} host waits per group")
        n14 = sum(st.num_active for st in shards)
        spps = n14 * (SHARD_STEPS - SHARD_CHECK) / swall
        print(f"  {n14} particles on {d} shards: {spps:.6e} particle-steps/s "
              f"({swall * 1e3 / (SHARD_STEPS - SHARD_CHECK):.4f} ms/step) on {card_line}")
        sh.occ_resort.zero_()
        ex = sh.gather_state(sh.rollout(shards, SHARD_BITWISE))
        ex_fb = int(sh.occ_resort)
        sh.resort = "global"
        gl = sh.gather_state(sh.rollout(shards, SHARD_BITWISE))
        sh.resort = "exchange"
        torch.cuda.synchronize()
        for k in gridops.state_fields(ex):
            if not torch.equal(_bits(getattr(ex, k)), _bits(getattr(gl, k))):
                raise AssertionError(f"{d} shards: exchange resort and global sort differ in {k}")
        print(f"  {SHARD_BITWISE} steps through the exchange resort ({ex_fb} fallbacks) and "
              "through the global sort: every field bitwise equal")
        sharded[d] = (sh, shards, s_launches)
    sh, shards, _ = sharded[2]
    s_cap = 1  # the shard whose sweeps are checked: the second
    shard_sweeps = check_shard_sweeps(f"2 shards, shard {s_cap}:", sh,
                                      shard_sweep_inputs(sh, shards, s_cap))
    return {k: sharded[2][2][k] + sharded[4][2][k] for k in kernels}, shard_sweeps


def sharded_rigid(tt, kernels, r_scene, card_line: str):
    """Phase 15: the coupled ``r_scene`` on 2 shards of one card; returns
    the launch counts."""
    from tisph_tpu_torch.parallel import ShardedWCSPH, make_mesh

    r_start = tagged(tt.build_state(r_scene, device=DEVICE))
    ref_r, ref_st, ref_rg = tt.make_solver(r_scene, r_start, device=DEVICE, resort_every=2)
    ref_st, ref_rg = ref_r.rollout_coupled(ref_st, ref_rg, SHARD_CHECK)
    sh = ShardedWCSPH(r_scene, make_mesh(devices=[DEVICE] * 2), resort_every=2, graphs=False)
    shards = sh.bind(r_start)
    rg = sh.init_rigid(shards)
    sel0 = (r_start.object_id == 0) & r_start.boundary_mask
    b_tags = r_start.color[sel0, 0]
    b_d0 = torch.linalg.vector_norm(r_start.x[sel0] - rg.com[0], dim=1)
    print(f"  boundary_mode {sh.boundary_mode}, {sh.shard_rows} rows a shard, halo {sh.halo} "
          f"({sh.halo_path}), edge {sh.resort_edge}")
    reset_counts(kernels)
    sh.occ_resort.zero_()
    shards, rg = sh.rollout_coupled(shards, rg, SHARD_CHECK)
    hold_to_single(f"coupled, 2 shards, {SHARD_CHECK} steps", sh.gather_state(shards), ref_st)
    body = {k: float((getattr(rg, k) - getattr(ref_rg, k)).abs().max())
            for k in ("com", "v_com", "omega")}
    print(f"  bodies vs WCSPHRigid: com {body['com']:.3e} (atol 1e-6), v_com "
          f"{body['v_com']:.3e} (1e-4), omega {body['omega']:.3e} (1e-4)")
    if not (body["com"] <= 1e-6 and body["v_com"] <= 1e-4 and body["omega"] <= 1e-4):
        raise AssertionError(f"coupled sharded bodies differ from WCSPHRigid's: {body}")
    t0 = time.perf_counter()
    shards, rg = sh.rollout_coupled(shards, rg, SHARD_RIGID - SHARD_CHECK)
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    c15 = {k: f.launches for k, f in kernels.items()}
    groups, fb = SHARD_RIGID // 2, int(sh.occ_resort)
    c_want = {k: 0 for k in kernels} | {
        "rebuild": (groups - fb) * 2 + fb, "csr_bounds": groups * 2,
        "sweep.bvol": SHARD_RIGID * 2, "sweep.density": SHARD_RIGID * 2,
        "sweep.force_react": SHARD_RIGID * 2}
    c_want = with_row_ops(c_want)
    if c15 != c_want:
        raise AssertionError(f"coupled sharded launch counts {c15}, expected {c_want}")
    whole = sh.gather_state(shards)
    m = sh.metrics(shards)
    drift = body_drift(whole, rg, b_tags, b_d0)
    print(f"  launches: {c15} ({fb} fallbacks)")
    print(f"  metrics: {m}; body shape drift {drift:.3e} (< 1e-4), com {rg.com[0].tolist()}")
    if m["nan_count"] != 0 or m["cfl"] >= 1.0 or m["occ_halo"] or not drift < 1e-4:
        raise AssertionError(f"coupled sharded run unhealthy: {m}, drift {drift}")
    c_waits = count_host_waits(lambda: sh.rollout_coupled(shards, rg, 2))
    print(f"  host waits per coupled R=2 group: {c_waits}; {whole.num_active} particles: "
          f"{whole.num_active * (SHARD_RIGID - SHARD_CHECK) / cwall:.6e} particle-steps/s "
          f"({cwall * 1e3 / (SHARD_RIGID - SHARD_CHECK):.4f} ms/step) on {card_line}")
    if c_waits != 1:
        raise AssertionError(f"coupled sharded group: {c_waits} host waits")
    return c15


def rect_demo(tt, kernels, scene, card_line: str):
    """Phase 17: ``scene`` on a 2x2 and a 2x2x2 mesh of one card; returns
    the launch counts of both runs added, kernel A's checks with an i-row
    map on a shard, and run_sharded's profile of the 2x2 mesh."""
    import contextlib
    import io

    from tisph_tpu_torch import run_sharded
    from tisph_tpu_torch.models.solver_base import SolverBase
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
    from tisph_tpu_torch.parallel import ShardedWCSPHRect, make_mesh2d, make_mesh3d

    print("  every shard on the one card: particle-steps/s here is what the exchanges cost, "
          "not any scaling")
    start = tagged(tt.build_state(scene, device=DEVICE))
    ref = tt.WCSPH(scene, device=DEVICE, resort_every=2)
    ref_check = ref.rollout(ref.bind(start), RECT_CHECK)
    total, runs = {k: 0 for k in kernels}, {}
    for shape in ((2, 2), (2, 2, 2)):
        d = math.prod(shape)
        label = "x".join(map(str, shape))
        make = make_mesh2d if len(shape) == 2 else make_mesh3d
        sh = ShardedWCSPHRect(scene, make(*shape, devices=[DEVICE] * d), resort_every=2)
        shards = sh.bind(start)
        print(f"  {label}: {d} shards of {sh.shard_rows} rows, live rows "
              f"{[st.num_active for st in shards]}, halo caps {sh.cap_h}, migration caps "
              f"{sh.cap_m}")
        reset_counts(kernels)
        shards = sh.rollout(shards, RECT_CHECK)
        errs = hold_to_single(f"{label}, {RECT_CHECK} steps", sh.gather_state(shards), ref_check)
        print(f"  {label}: x, v and density bitwise equal to the single-device run: "
              f"{all(e == 0 for e in errs)} (largest errors {errs})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = sh.rollout(shards, RECT_STEPS - RECT_CHECK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in kernels.items()}
        groups = RECT_STEPS // 2
        want = {k: 0 for k in kernels} | {
            "rebuild": groups * d, "csr_bounds": groups * d,
            "sweep.density": RECT_STEPS * d, "sweep.force": RECT_STEPS * d}
        want = with_row_ops(want)
        maps = {m: getattr(cuda_sweeps, f"{m}_sweep").part_launches for m in ("density", "force")}
        if got != want or maps != {"density": RECT_STEPS * d, "force": RECT_STEPS * d}:
            raise AssertionError(f"{label}: launch counts {got} ({maps} with an i-row map), "
                                 f"expected {want}, every sweep with an i-row map")
        m = sh.metrics(shards)
        print(f"  launches: {got}; with an i-row map: {maps} ({groups} groups: the rebuild "
              f"pass and the bounds-only launch once per shard per group)")
        print(f"  metrics: {m}")
        if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
            raise AssertionError(f"{label} unhealthy: {m}")
        if m["occ_halo"] or m["migrate_anomalies"] or m["dropped_rows"]:
            raise AssertionError(f"{label}: halo overflow, migration trips or dropped rows: {m}")
        # one R=2 group, its build and two substeps, without the call's end
        group = lambda: SolverBase._groups(sh, (shards,), 2, 2, sh._substep)  # noqa: E731
        g_waits, waits = count_host_waits(group), count_host_waits(lambda: sh.rollout(shards, 2))
        print(f"  host reads: {g_waits} in one R=2 group, {waits} in one rollout call (its "
              "one read of the shards' live rows and the dropped-row count)")
        if g_waits != 0 or waits != 1:
            raise AssertionError(f"{label}: {g_waits} host waits in a group, {waits} in a call")
        if len(shape) == 2:
            # the group is one graph replay on one card; its build and a
            # substep, called eagerly as a mesh over several devices runs
            # them, queue behind the spin each alone (a whole eager group's
            # 1,400-odd launches overfill the launch queue)
            assert_no_host_wait(f"{label}, a whole R=2 group (a graph replay)", group)
            st_b, caches = sh._build(shards)
            assert_no_host_wait(f"{label}, a group's build", lambda: sh._build(shards))
            assert_no_host_wait(f"{label}, a substep", lambda: sh._substep((st_b,), caches))
        n17 = sum(st.num_active for st in shards)
        print(f"  {n17} particles on {label}: "
              f"{n17 * (RECT_STEPS - RECT_CHECK) / wall:.6e} particle-steps/s "
              f"({wall * 1e3 / (RECT_STEPS - RECT_CHECK):.4f} ms/step) on {card_line}")
        total = {k: total[k] + got[k] for k in kernels}
        runs[label] = (sh, shards)
    sh, shards = runs["2x2"]
    a_checks = check_shard_sweeps("2x2, shard 1:", sh, rect_sweep_inputs(sh, shards, 1))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_sharded.main([DEMO_3D, "--mesh2d", "2x2", "--devices", ",".join([DEVICE] * 4),
                               "--resort", "2", "--steps", "20", "--profile", "20"])
    out = buf.getvalue().strip().splitlines()
    print("\n".join(f"  run_sharded: {line}" for line in out))
    if rc != 0:
        raise AssertionError(f"run_sharded --mesh2d 2x2 exited {rc}")
    return total, a_checks, json.loads(out[-1])


def rect_rigid(tt, kernels, r_scene, card_line: str):
    """Phase 18: the coupled ``r_scene`` on a 2x2 mesh of one card; returns
    the launch counts."""
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
    from tisph_tpu_torch.parallel import ShardedWCSPHRect, make_mesh2d

    start = tagged(tt.build_state(r_scene, device=DEVICE))
    ref_r, ref_st, ref_rg0 = tt.make_solver(r_scene, start, device=DEVICE, resort_every=2)
    ref_st, ref_rg = ref_r.rollout_coupled(ref_st, ref_rg0, RECT_CHECK)
    sh = ShardedWCSPHRect(r_scene, make_mesh2d(2, 2, devices=[DEVICE] * 4), resort_every=2)
    shards = sh.bind(start)
    # the bodies' mass and com summed over the shards' rows, in another order
    # than the single device's: the held run starts from WCSPHRigid's bodies
    own = sh.init_rigid(shards)
    d_com = float((own.com - ref_rg0.com).abs().max())
    d_mass = float(((own.mass - ref_rg0.mass) / ref_rg0.mass).abs().max())
    print(f"  init_rigid on the shards vs WCSPHRigid's: com {d_com:.3e} (atol 1e-5), mass rel "
          f"{d_mass:.3e} (1e-5): the body rows summed in the shards' order")
    if not (d_com <= 1e-5 and d_mass <= 1e-5):
        raise AssertionError(f"init_rigid on the shards: com {d_com}, mass {d_mass}")
    rg = ref_rg0
    sel0 = (start.object_id == 0) & start.boundary_mask
    b_tags = start.color[sel0, 0]
    b_d0 = torch.linalg.vector_norm(start.x[sel0] - rg.com[0], dim=1)
    print(f"  boundary_mode {sh.boundary_mode}, {sh.shard_rows} rows a shard, live rows "
          f"{[st.num_active for st in shards]}, halo caps {sh.cap_h}")
    reset_counts(kernels)
    shards, rg = sh.rollout_coupled(shards, rg, RECT_CHECK)
    hold_to_single(f"coupled, 2x2, {RECT_CHECK} steps", sh.gather_state(shards), ref_st)
    body = {k: float((getattr(rg, k) - getattr(ref_rg, k)).abs().max())
            for k in ("com", "v_com", "omega")}
    print(f"  bodies vs WCSPHRigid: com {body['com']:.3e} (atol 1e-6), v_com "
          f"{body['v_com']:.3e} (1e-4), omega {body['omega']:.3e} (1e-4)")
    if not (body["com"] <= 1e-6 and body["v_com"] <= 1e-4 and body["omega"] <= 1e-4):
        raise AssertionError(f"coupled rectangle bodies differ from WCSPHRigid's: {body}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards, rg = sh.rollout_coupled(shards, rg, RECT_RIGID - RECT_CHECK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: f.launches for k, f in kernels.items()}
    groups = RECT_RIGID // 2
    want = {k: 0 for k in kernels} | {
        "rebuild": groups * 4, "csr_bounds": groups * 4, "sweep.bvol": RECT_RIGID * 4,
        "sweep.density": RECT_RIGID * 4, "sweep.force_react": RECT_RIGID * 4}
    want = with_row_ops(want)
    maps = {m: getattr(cuda_sweeps, f"{m}_sweep").part_launches
            for m in ("bvol", "density", "force_react")}
    if got != want or set(maps.values()) != {RECT_RIGID * 4}:
        raise AssertionError(f"coupled rectangle launch counts {got} ({maps} with an i-row "
                             f"map), expected {want}")
    whole = sh.gather_state(shards)
    m = sh.metrics(shards)
    drift = body_drift(whole, rg, b_tags, b_d0)
    print(f"  launches: {got}; with an i-row map: {maps}")
    print(f"  metrics: {m}; body shape drift {drift:.3e} (< 1e-4), com {rg.com[0].tolist()}")
    if (m["nan_count"] != 0 or m["cfl"] >= 1.0 or m["occ_halo"] or m["dropped_rows"]
            or not drift < 1e-4):
        raise AssertionError(f"coupled rectangle run unhealthy: {m}, drift {drift}")
    waits = count_host_waits(lambda: sh.rollout_coupled(shards, rg, 2))
    print(f"  host reads per coupled rollout call: {waits}; {whole.num_active} particles: "
          f"{whole.num_active * (RECT_RIGID - RECT_CHECK) / wall:.6e} particle-steps/s "
          f"({wall * 1e3 / (RECT_RIGID - RECT_CHECK):.4f} ms/step) on {card_line}")
    if waits != 1:
        raise AssertionError(f"coupled rectangle call: {waits} host waits")
    return got


def linear_sharded(tt, kernels, scene, card_line: str):
    """Phase 19: ``scene`` on the linear layout at R=1 on 2 and 4 slab
    shards of one card; returns the launch counts of both runs added and
    kernel C's checks over a shard's row range."""
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
    from tisph_tpu_torch.parallel import ShardedWCSPH, make_mesh

    start = tagged(tt.build_state(scene, device=DEVICE))
    ref = tt.WCSPH(scene, device=DEVICE, layout="linear")
    ref_check = ref.rollout(ref.bind(start), RECT_CHECK)
    total, runs = {k: 0 for k in kernels}, {}
    for d in (2, 4):
        sh = ShardedWCSPH(scene, make_mesh(devices=[DEVICE] * d), layout="linear", graphs=False)
        shards = sh.bind(start)
        reset_counts(kernels)
        sh.occ_resort.zero_()
        shards = sh.rollout(shards, RECT_CHECK)
        errs = hold_to_single(f"linear, {d} shards, {RECT_CHECK} steps", sh.gather_state(shards),
                              ref_check)
        print(f"  {d} shards: x, v and density bitwise equal to the single-device linear run: "
              f"{all(e == 0 for e in errs)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = sh.rollout(shards, LIN_SHARD_STEPS - RECT_CHECK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in kernels.items()}
        fb = int(sh.occ_resort)
        want = {k: 0 for k in kernels} | {
            "rebuild": (LIN_SHARD_STEPS - fb) * d + fb, "csr_bounds": LIN_SHARD_STEPS * d,
            "linear.density": LIN_SHARD_STEPS * d, "linear.force": LIN_SHARD_STEPS * d}
        want = with_row_ops(want)
        ranged = {m: getattr(cuda_sweeps, f"{m}_sweep_linear").part_launches
                  for m in ("density", "force")}
        if got != want or set(ranged.values()) != {LIN_SHARD_STEPS * d}:
            raise AssertionError(f"linear, {d} shards: launch counts {got} ({ranged} over a "
                                 f"row range), expected {want}")
        m = sh.metrics(shards)
        print(f"  launches: {got}; C over a row range: {ranged} ({fb} seam-guard fallbacks)")
        print(f"  metrics: {m}")
        if m["nan_count"] != 0 or m["cfl"] >= 1.0 or m["occ_halo"]:
            raise AssertionError(f"linear, {d} shards unhealthy: {m}")
        n19 = sum(st.num_active for st in shards)
        print(f"  {n19} particles on {d} shards: "
              f"{n19 * (LIN_SHARD_STEPS - RECT_CHECK) / wall:.6e} particle-steps/s "
              f"({wall * 1e3 / (LIN_SHARD_STEPS - RECT_CHECK):.4f} ms/step) on {card_line}")
        total = {k: total[k] + got[k] for k in kernels}
        runs[d] = (sh, shards)
    sh, shards = runs[2]
    c_checks = check_shard_sweeps("linear, 2 shards, shard 1:", sh,
                                  shard_sweep_inputs(sh, shards, 1), linear=True)
    return total, c_checks


def viewers_and_utils(solver, scene, state):
    """Phase 16: validate_state, checked_step, StepTimer and the orbit
    viewer on ``solver``'s ``state``."""
    import tisph_tpu_torch as tt
    from tisph_tpu_torch.render.orbit import OrbitViewer, scene_camera
    from tisph_tpu_torch.utils import debug, profiling

    probs = debug.validate_state(state, solver.params, strict=True)
    checked = debug.checked_step(solver.step, solver.params)
    after = checked(state)
    bad = dataclasses.replace(state, v=state.v.clone())
    bad.v[5, 0] = float("nan")
    try:
        checked(bad)
    except RuntimeError as e:
        caught = str(e)
    else:
        raise AssertionError("checked_step let a non-finite velocity through")
    timer = profiling.StepTimer()
    st16 = after
    for _ in range(5):
        with timer("rollout, one R=2 group", result=st16):
            st16 = solver.rollout(st16, 2)
    print(f"  validate_state: {probs}; checked_step: clean step passed, NaN step raised "
          f"{caught!r}")
    print("  StepTimer: " + timer.report())
    try:
        import matplotlib  # noqa: F401  (the viewer's canvas)
    except ImportError:
        # this machine has no matplotlib: the orbit view's camera pipeline
        # runs on the state's host copy without a canvas
        x = tt.state_to_host(st16)["x"]
        xy, z, vis = scene_camera(scene).project(x)
        print(f"  matplotlib is not installed here, so no PNG: the orbit camera projected "
              f"{int(vis.sum())} of {len(x)} particles in front of it, depth "
              f"{float(z[vis].min()):.4f}-{float(z[vis].max()):.4f}")
        if not (vis.all() and np.isfinite(xy).all()):
            raise AssertionError("the orbit camera lost particles of the state")
        return
    viewer = OrbitViewer(scene, interactive=False)
    viewer.show(st16)
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "orbit.png")
        viewer.savefig(png)
        size = os.path.getsize(png)
    viewer.close()
    print(f"  OrbitViewer (Agg): {st16.num_active} particles rendered to a {size}-byte PNG")
    if size < 10_000:
        raise AssertionError(f"the orbit view PNG is {size} bytes")


def groups_of(steps: int, chunk: int, R: int) -> int:
    """The R-groups (rebuilds) of ``steps`` substeps run in rollouts of
    ``chunk``: each rollout starts a group."""
    return (steps // chunk) * -(-chunk // R) + -(-(steps % chunk) // R)


def soak_run(kernels, path: str, steps: int, chunk: int, card_line: str):
    """One soak of phase 20 through ``tools.soak`` at R=2 (its per-chunk
    rates printed by ``run``): the launch counters against the chunks'
    groups, no NaN, CFL < 1, every particle still live.  Returns the
    record, the solver, the end state and the launch counts."""
    from tisph_tpu_torch.tools import soak

    reset_counts(kernels)
    rec, solver, state = soak.soak(path, steps, 2, chunk, torch.device(DEVICE))
    got = {k: f.launches for k, f in kernels.items()}
    bind = int(bool(state.boundary_mask.any()))  # static volumes at bind
    want = {k: 0 for k in kernels} | {"rebuild": bind + groups_of(steps, chunk, 2),
                                      "sweep.bvol": bind, "sweep.density": steps,
                                      "sweep.force": steps}
    want = with_row_ops(want)
    m = rec["metrics"]
    print(f"  record: {json.dumps(rec)}")
    print(f"  launches: {got}")
    if got != want:
        raise AssertionError(f"soak of {path}: launch counts {got}, expected {want}")
    if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
        raise AssertionError(f"soak of {path} unhealthy: {m}")
    if not m["num_active"] == rec["particles"] == state.num_active:
        raise AssertionError(f"soak of {path}: {rec['particles']} particles at the start, "
                             f"{m['num_active']} at the end")
    print(f"  {rec['particles']} particles, {steps} steps ({rec['sim_seconds']:.3f} simulated "
          f"s) in chunks of {chunk}: {rec['pps_wall']:.6e} particle-steps/s over the run, "
          f"{rec['wall_s']:.3f} s, on {card_line}")
    return rec, solver, state, got


def long_run(tt, kernels, times5: dict, card_line: str):
    """Phase 20: demo_3d 10,000 steps and bench_3d_1m 2,500 through
    ``tools.soak``, then kernel A's density and force on demo_3d's end
    state; returns the launch counts, A's errors there and demo_3d's end
    metrics."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps

    rec, solver, state, launches = soak_run(kernels, DEMO_3D, SOAK_STEPS, SOAK_CHUNK, card_line)
    with open(os.path.join(HERE, "artifacts", "soak_r04.json")) as f:
        tpu = json.load(f)["metrics"]
    m = rec["metrics"]
    print("  end state beside artifacts/soak_r04.json's (the same scene, steps and R on the "
          "TPU; physics, not speed):")
    for k in ("max_velocity", "avg_density_error", "max_density_error"):
        print(f"    {k:<18} {m[k]:.6f}  (TPU soak {tpu[k]:.6f})")

    print(f"  kernel A on demo_3d after {SOAK_STEPS} steps (piled up) against its plain "
          "version:")
    inp = sweep_inputs(solver, state)
    errs = check_sweeps(f"demo_3d+{SOAK_STEPS}", solver, inp)
    st, ids, bnd, mat = inp["st"], inp["ids"], inp["bounds"], inp["st"].material
    sp, pr = solver.spec, solver.params
    piled = time_against_plain({
        "density": (lambda: cuda_sweeps.density_sweep(inp["pos"], ids, bnd, mat, sp, pr),
                    lambda: neighbors.density_sweep(inp["pos"], ids, bnd, mat, sp, pr), 20, 2),
        "force": (lambda: cuda_sweeps.force_sweep(inp["pos"], inp["vel"], inp["aux"], ids, bnd,
                                                  mat, sp, pr),
                  lambda: neighbors.force_sweep(inp["pos"], inp["vel"], inp["aux"], ids, bnd,
                                                mat, sp, pr), 20, 2),
    })
    for mode in ("density", "force"):
        bms, by = sweep_bound(mode, inp, solver)
        k5, p5 = times5[f"sweep.{mode}"]
        print(f"  A {mode:<7} after {SOAK_STEPS} steps: kernel {piled[mode][0]:.4f} ms, plain "
              f"{piled[mode][1]:.4f} ms, bound {bms:.5f} ms ({by}); after "
              f"{STEPS_R2 + STEPS_R1 + 2} steps (phase 5): kernel {k5:.4f} ms, plain "
              f"{p5:.4f} ms; on {card_line}")
    del solver, state, inp

    rec, _, _, got = soak_run(kernels, LARGE_3D, SOAK_1M_STEPS, SOAK_1M_CHUNK, card_line)
    launches = {k: launches[k] + got[k] for k in kernels}
    return launches, errs, m


def cadence_and_compat(kernels, card_line: str):
    """Phase 21: ``tools.compare_resort`` on demo_3d at R=2 and R=3 and
    ``tools.compare_compat`` on demo_2d; returns the launch counts."""
    from tisph_tpu_torch.tools import compare_compat, compare_resort

    dev = torch.device(DEVICE)
    reset_counts(kernels)
    # tisph_tpu's figures on the TPU (ROADMAP.md, "Facts that hold on any
    # hardware"): physics, not speed
    tpu = {2: "0.13 h (p99 0.50 h)", 3: "0.29 h"}
    res = {}
    for R in (2, 3):
        res[R] = compare_resort.compare(DEMO_3D, R, RESORT_STEPS, dev)
        r = res[R]
        print(f"  compare_resort demo_3d R={R} against R=1 after {RESORT_STEPS} steps: rmse "
              f"{r['rmse']:.6e} m = {r['rmse_over_h']:.6f} h, max {r['max_over_h']:.6f} h, "
              f"p99 {r['p99_over_h']:.6f} h (TPU round: {tpu[R]})")
    if not res[2]["rmse_over_h"] < 0.5:
        raise AssertionError(f"R=2 diverges from R=1 by {res[2]['rmse_over_h']} h RMSE (>= 0.5 h)")
    out = {name: compare_compat.compare(DEMO_2D, name, steps // COMPAT_SUBSTEPS,
                                        COMPAT_SUBSTEPS, dev)
           for name, steps in COMPAT_STEPS.items()}
    readme = {("wcsph", 50): 0.45, ("wcsph", 100): 1.15, ("legacy", 50): 0.00}
    for (name, step), want in readme.items():
        row = next(r for r in out[name]["rows"] if r["step"] == step)
        if not math.isfinite(row["rmse"]):
            raise AssertionError(f"compare_compat {name} step {step}: non-finite RMSE")
        print(f"  compare_compat demo_2d {name:<6} {step:>3} steps: pos RMSE {row['rmse']:.6f} m "
              f"= {row['rmse_over_h']:.4f} h (README: {want:.2f} h)")
    got = {k: f.launches for k, f in kernels.items()}
    # each tool runs its two modes; the legacy solver rebuilds every step and
    # sweeps through csrc/legacy.cu, replaying one graph a step
    resort = sum(groups_of(RESORT_STEPS, RESORT_CHUNK, 1) + groups_of(RESORT_STEPS, RESORT_CHUNK, R)
                 for R in (2, 3))
    wc, lg = 2 * COMPAT_STEPS["wcsph"], 2 * COMPAT_STEPS["legacy"]
    want = {k: 0 for k in kernels} | {"rebuild": resort + wc + lg,
                                      "sweep.density": 4 * RESORT_STEPS + wc,
                                      "sweep.force": 4 * RESORT_STEPS + wc,
                                      "legacy_density": lg, "legacy_force": lg}
    want = with_row_ops(want)
    print(f"  launches: {got}")
    if got != want:
        raise AssertionError(f"phase 21 launch counts {got}, expected {want}")
    return got


def coupled_long_runs(tt, kernels, r_scene, card_line: str):
    """Phase 22: test_buoyancy's scenes through ``ShardedWCSPH.run_coupled``
    on one shard and the light one on 2 slab shards, then
    ``WCSPHRigid.run_coupled`` against ``rollout_coupled`` bitwise;
    returns the launch counts."""
    from tisph_tpu_torch.models.state import SimState
    from tisph_tpu_torch.ops import grid as gridops
    from tisph_tpu_torch.parallel import ShardedWCSPH, make_mesh

    total = {k: 0 for k in kernels}
    with tempfile.TemporaryDirectory() as tmp:
        for density, d in ((200.0, 1), (5000.0, 1), (200.0, 2)):
            scene = pool_scene(tt, density, tmp)
            sh = ShardedWCSPH(scene, make_mesh(devices=[DEVICE] * d), graphs=False)
            shards = sh.bind(tt.build_state(scene, device=DEVICE))
            rigid = sh.init_rigid(shards)
            reset_counts(kernels)
            t0 = time.perf_counter()
            shards, rigid = sh.run_coupled(shards, rigid, BUOYANCY_STEPS)
            com = rigid.com[0].tolist()
            wall = time.perf_counter() - t0
            got = {k: f.launches for k, f in kernels.items()}
            groups = groups_of(BUOYANCY_STEPS, 400, sh.resort_every)
            # rebuild: d per exchange group, 1 per fallback to the global sort
            fb = (groups * d - got["rebuild"]) // (d - 1) if d > 1 else 0
            want = {k: 0 for k in kernels} | {
                "rebuild": (groups - fb) * d + fb, "csr_bounds": groups * d,
                "sweep.bvol": BUOYANCY_STEPS * d, "sweep.density": BUOYANCY_STEPS * d,
                "sweep.force_react": BUOYANCY_STEPS * d}
            want = with_row_ops(want)
            m = sh.metrics(shards)
            n = sum(st.num_active for st in shards)
            print(f"  density {density:g} on {d} shard(s): {n} particles, com after "
                  f"{BUOYANCY_STEPS} steps = {com}, {wall * 1e3 / BUOYANCY_STEPS:.4f} ms/step "
                  f"on {card_line}; metrics {m}")
            print(f"  launches: {got}")
            if got != want or not 0 <= fb <= groups:
                raise AssertionError(f"run_coupled on {d} shard(s): launch counts {got}, "
                                     f"expected {want}")
            if m["nan_count"] or m["cfl"] >= 1.0 or not all(math.isfinite(c) for c in com):
                raise AssertionError(f"run_coupled density {density} on {d} shard(s) unhealthy")
            if (com[1] > 0.27) != (density < 1000):
                raise AssertionError(f"density {density} on {d} shard(s): com_y {com[1]} on the "
                                     "wrong side of 0.27 (the light box floats, the heavy sinks)")
            total = {k: total[k] + got[k] for k in kernels}

    solver, state, rigid = tt.make_solver(r_scene, tt.build_state(r_scene, device=DEVICE),
                                          device=DEVICE, resort_every=2)
    reset_counts(kernels)
    by_run = solver.run_coupled(state, rigid, COUPLED_RUN, check_every=COUPLED_CHECK)
    by_roll = solver.rollout_coupled(state, rigid, COUPLED_RUN)
    torch.cuda.synchronize()
    got = {k: f.launches for k, f in kernels.items()}
    for (a, b) in zip(by_run, by_roll):
        names = (gridops.state_fields(a) if isinstance(a, SimState)
                 else [f.name for f in dataclasses.fields(a)])
        for k in names:
            if not torch.equal(_bits(getattr(a, k)), _bits(getattr(b, k))):
                raise AssertionError(f"run_coupled(check_every={COUPLED_CHECK}) and "
                                     f"rollout_coupled differ in {k} after {COUPLED_RUN} steps")
    want = {k: 0 for k in kernels} | {
        "rebuild": 2 * (COUPLED_RUN // 2), "sweep.bvol": 2 * COUPLED_RUN,
        "sweep.density": 2 * COUPLED_RUN, "sweep.force_react": 2 * COUPLED_RUN}
    want = with_row_ops(want)
    print(f"  bench_3d_rigid: WCSPHRigid.run_coupled({COUPLED_RUN}, check_every="
          f"{COUPLED_CHECK}) at R=2 and rollout_coupled({COUPLED_RUN}): every particle and body "
          f"field bitwise equal; com {by_run[1].com[0].tolist()}")
    print(f"  launches: {got}")
    if got != want:
        raise AssertionError(f"run_coupled / rollout_coupled launch counts {got}, expected {want}")
    return {k: total[k] + got[k] for k in kernels}


def legacy_inputs(solver, state):
    """The sorted state and the legacy sweeps' packs of one step, as
    ``WCSPHLegacy._apply`` makes them (its density from the plain version,
    so both sides of every comparison read identical inputs)."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.eos import tait_pressure
    from tisph_tpu_torch.ops.grid import csr_bounds, sort_state_by_cell

    spec, params = solver.spec, solver.params
    st, ids, _ = sort_state_by_cell(state, spec)
    bounds = csr_bounds(ids, spec)
    pos = neighbors.legacy_pos(st)
    rho = neighbors.legacy_density_sweep(pos, ids, bounds, st.material, spec, params)
    rho, p = tait_pressure(torch.where(st.fluid_mask, rho, st.density), params.density0,
                           params.stiffness, params.exponent)
    vel, aux = neighbors.legacy_force_packs(st, rho, p)
    return {"st": st, "ids": ids, "bounds": bounds, "pos": pos, "vel": vel, "aux": aux}


def legacy_call(lib, mode: str, solver, inp, lanes: int | None = None):
    """One call of ``lib``'s (the kernel's wrapper or the plain version)
    legacy sweep in ``mode`` ("legacy_density" or "legacy_force"); the
    kernel at ``lanes`` lanes a row where given (``_launch``, uncounted),
    else through its wrapper at its rule's."""
    args = (inp["ids"], inp["bounds"], inp["st"].material, solver.spec, solver.params)
    if lanes is not None:
        packs = (inp["pos"], None, None) if mode == "legacy_density" else (
            inp["pos"], inp["vel"], inp["aux"])
        return lib._launch(mode[len("legacy_"):], lanes, *packs, *args)
    if mode == "legacy_density":
        return lib.legacy_density_sweep(inp["pos"], *args)
    return lib.legacy_force_sweep(inp["pos"], inp["vel"], inp["aux"], *args)


def check_legacy(label: str, solver, inp) -> dict[str, float]:
    """csrc/legacy.cu against its plain version in both modes, at every
    built lane count: two calls bitwise equal, finite, 0 off the fluid
    rows, density rtol 2e-5 and force / max|force| atol 5e-6 on them, the
    margin (the limit over the error) printed; the rule's launch bitwise
    the lane count it picks.  Returns the max abs errors over every count."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import legacy

    rtol, atol_f = TOL[False]
    fl = inp["st"].fluid_mask
    errs = {}
    for mode in ("legacy_density", "legacy_force"):
        ref = legacy_call(neighbors, mode, solver, inp)
        rule, _ = legacy.legacy_launch_shape(solver.spec.dim, fl.numel())
        by_lanes = {}
        for lanes in legacy.LANES:
            got = legacy_call(legacy, mode, solver, inp, lanes)
            again = legacy_call(legacy, mode, solver, inp, lanes)
            torch.cuda.synchronize()
            what = f"{label} {mode} lanes={lanes}"
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two calls on the same input differ")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{what}: non-finite output")
            if not torch.equal(got[~fl], torch.zeros_like(got[~fl])):
                raise AssertionError(f"{what}: rows off the fluid family not 0")
            err = float((got - ref).abs().max())
            if mode == "legacy_force":
                rel, limit = err / float(ref[fl].abs().max()), atol_f
                detail = f"max|err|/max|ref| = {rel:.3e} (atol {atol_f}"
            else:
                rel = float(((got - ref)[fl].abs() / ref[fl].abs().clamp(min=1e-30)).max())
                limit, detail = rtol, f"max rel err = {rel:.3e} (rtol {rtol}"
            margin = limit / rel if rel > 0 else math.inf
            print(f"  {label:<14} {mode:<14} L={lanes:<2} rows={int(fl.sum())} of {fl.numel()} "
                  f"max|err|={err:.3e} {detail}, margin {margin:.1f}x)")
            if not rel <= limit:
                raise AssertionError(f"{what}: {detail})")
            by_lanes[lanes] = got
            errs[mode] = max(errs.get(mode, 0.0), err)
        if not torch.equal(legacy_call(legacy, mode, solver, inp), by_lanes[rule]):
            raise AssertionError(f"{label} {mode}: the rule's launch differs from lanes={rule}")
    return errs


def legacy_lane_times(label: str, solver, inp, card_line: str) -> dict:
    """The kernel's times on ``inp`` at every built lane count (the counts
    timed in order and again in reverse, means of the two), the rule's
    launch shape, its bound and the share of it that the rule's launch
    reaches; returns the bounds (``legacy_bounds``)."""
    from tisph_tpu_torch.ops.cuda import legacy

    n = inp["st"].capacity
    reps = 20 if n >= 100_000 else 200
    bounds = legacy_bounds(inp, solver)
    for mode in ("legacy_density", "legacy_force"):
        ms = {lanes: 0.0 for lanes in legacy.LANES}
        for order in (legacy.LANES, legacy.LANES[::-1]):
            for lanes in order:
                ms[lanes] += cuda_ms(lambda lanes=lanes: legacy_call(legacy, mode, solver, inp,
                                                                     lanes), reps) / 2
        rule, ctas = legacy.legacy_launch_shape(solver.spec.dim, n)
        b_ms, by = bounds[mode]
        print(f"  lanes {label} {mode}: " + ", ".join(f"L={k} {v:.4f}" for k, v in ms.items())
              + f" ms; the rule: {rule} lanes, {ctas} CTAs, {ms[rule]:.4f} ms, bound "
              f"{b_ms:.5f} ms ({by}), {b_ms / ms[rule]:.2%} of it reached; {n} rows; "
              f"on {card_line}")
    return bounds


def legacy_bounds(inp, solver) -> dict[str, tuple[float, str]]:
    """{mode: (bound ms, "bytes" or "operations")} of both legacy sweeps
    on ``inp``: bytes = its packs (pos; vel and aux for force), ids,
    material, the CSR bounds and its output; operations = the pairs (fluid
    i, j != i inside h; fluid j for density, every live j for force),
    counted in one pass over the candidates, times LEGACY_FLOPS_PER_PAIR at
    the state's dim."""
    from tisph_tpu_torch.ops import neighbors

    st = inp["st"]
    n, dim, nc = st.capacity, solver.spec.dim, solver.spec.num_cells
    fl, x, h2 = st.fluid_mask, st.x, solver.params.support_length ** 2
    counts = torch.zeros(2, dtype=torch.int64, device=DEVICE)
    for i, j in neighbors.candidates(inp["ids"], inp["bounds"], torch.nonzero(fl).squeeze(1),
                                     solver.spec):
        d = x[i] - x[j]
        near = (torch.sum(d * d, dim=1) < h2) & (i != j)
        counts += torch.stack([(near & fl[j]).sum(), (near & st.active_mask[j]).sum()])
    out = {}
    for mode, pairs in zip(("legacy_density", "legacy_force"), counts.tolist()):
        force = mode == "legacy_force"
        nbytes = (n * (16 + 4 + 4) + (nc + 1) * 4
                  + (2 * n * 16 + n * dim * 4 if force else n * 4))
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = pairs * LEGACY_FLOPS_PER_PAIR[mode][dim] / F32_FLOPS
        print(f"  bound {mode:<14} {nbytes / 1e6:.3f} MB -> {t_bytes * 1e3:.5f} ms, {pairs} pairs "
              f"-> {t_ops * 1e3:.5f} ms ({pairs / max(int(fl.sum()), 1):.1f} pairs a fluid row)")
        out[mode] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def legacy_path(tt, kernels, card_line: str):
    """Phase 13: ``WCSPHLegacy`` on demo_2d, on the graph path and on the
    eager loop; the kernel at every lane count on four states; demo_3d's
    legacy path in turns.  Returns the graph runs' launches, the kernel's
    errors, times (kernel, plain) and bounds on demo_2d's state, and that
    state's rows."""
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import legacy

    l2_scene = tt.load_scene(DEMO_2D)
    starts = {}
    for dev in ("cpu", DEVICE):
        st = tt.build_state(l2_scene, device=dev)
        tag = torch.arange(st.capacity, dtype=torch.float32, device=dev)
        starts[dev] = dataclasses.replace(st, color=torch.cat([tag[:, None], st.color[:, 1:]], 1))
    g = tt.WCSPHLegacy(l2_scene, device=DEVICE)
    e = tt.WCSPHLegacy(l2_scene, device=DEVICE, graphs=False)
    if not (g.graphs and g.eager_loop is None and not e.graphs):
        raise AssertionError(f"legacy: graphs {g.graphs} / {e.graphs}, want True / False")
    sg, se = g.bind(starts[DEVICE]), e.bind(starts[DEVICE])
    each = {"rebuild": LEGACY_STEPS, "legacy_density": LEGACY_STEPS,
            "legacy_force": LEGACY_STEPS}
    got, want, total = graph_against_eager(
        kernels, f"legacy demo_2d, {LEGACY_STEPS} steps", lambda: g.rollout(sg, LEGACY_STEPS),
        lambda: e.rollout(se, LEGACY_STEPS), each)
    same_bits("legacy demo_2d", got, want)
    print(f"  legacy demo_2d: graphs=True bitwise equal to graphs=False in every field after "
          f"{LEGACY_STEPS} steps; {g._runner.captures} capture(s), keys "
          f"{sorted(g._runner._graphs)}")

    cpu_solver = tt.WCSPHLegacy(l2_scene, device="cpu")
    ref = cpu_solver.rollout(cpu_solver.bind(starts["cpu"]), LEGACY_CHECK)
    reset_counts(kernels)
    check = g.rollout(sg, LEGACY_CHECK)
    torch.cuda.synchronize()
    total = {k: total[k] + kernels[k].launches for k in kernels}

    def by_tag(st):
        order = torch.argsort(st.color[:st.num_active, 0])
        return st.x[:st.num_active][order].cpu()

    x_err = float((by_tag(check) - by_tag(ref)).abs().max())
    print(f"  {check.num_active} particles, {LEGACY_CHECK} steps: card (graph path) vs CPU x "
          f"max|err| {x_err:.3e} (atol 1e-5)")
    if not x_err <= 1e-5:
        raise AssertionError(f"legacy on the card differs from the CPU: {x_err:.3e}")

    m = g.metrics(got)
    lo, hi = (torch.tensor(v, device=DEVICE) for v in
              ([s + l2_scene.padding for s in l2_scene.domain_start],
               [e - l2_scene.padding for e in l2_scene.domain_end]))
    fx = got.x[got.fluid_mask]
    inside = bool(((fx >= lo - 1e-6) & (fx <= hi + 1e-6)).all())
    print(f"  metrics after {LEGACY_STEPS} steps: {m}; fluid inside the padded box: {inside}")
    if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
        raise AssertionError(f"legacy path unhealthy: {m}")
    if not inside:
        raise AssertionError("legacy fluid left the padded box")

    # one eager step, build and apply, must not make the host wait
    state, cache = e._build(got)
    e._apply(state, cache)
    assert_no_host_wait("legacy demo_2d, one eager step (_build and _apply)",
                        lambda: e._apply(*e._build(got)))

    # the kernel against its plain version on demo_2d's evolved state, on
    # the 3D golden scene's start (a boundary block) and, below, on demo_3d
    # and bench_3d_1m
    inp = legacy_inputs(g, got)
    errs = check_legacy(f"demo_2d+{LEGACY_STEPS}", g, inp)
    g3 = tt.WCSPHLegacy(tt.scene_from_dict(GOLDEN["3d_dam_break"][0]), device=DEVICE)
    g3_inp = legacy_inputs(g3, g3.bind(tt.build_state(g3.scene, device=DEVICE)))
    if not bool(g3_inp["st"].boundary_mask.any()):
        raise AssertionError("the 3D legacy check state has no boundary row")

    # boundary_mode="per_step": the bvol sweep and both legacy sums in one
    # graph a step, on the 3D golden scene's boundary block
    pg, pe = (tt.WCSPHLegacy(g3.scene, device=DEVICE, boundary_mode="per_step", graphs=gr)
              for gr in (None, False))
    p_start = pg.bind(tt.build_state(g3.scene, device=DEVICE))
    pe.bind(p_start)
    p_got, p_want, counted = graph_against_eager(
        kernels, f"legacy golden_3d per_step, {LEGACY_PER_STEP} steps",
        lambda: pg.rollout(p_start, LEGACY_PER_STEP), lambda: pe.rollout(p_start, LEGACY_PER_STEP),
        {k: LEGACY_PER_STEP for k in ("rebuild", "sweep.bvol", "legacy_density", "legacy_force")})
    same_bits("legacy golden_3d per_step", p_got, p_want)
    total = {k: total[k] + counted[k] for k in kernels}
    print(f"  legacy golden_3d per_step: graphs=True bitwise equal to graphs=False in every "
          f"field after {LEGACY_PER_STEP} steps; {pg._runner.captures} capture(s)")
    errs = {k: max(v, w) for (k, v), w in
            zip(errs.items(), check_legacy("golden_3d+0", g3, g3_inp).values())}
    states = {f"demo_2d+{LEGACY_STEPS}": (g, inp), "golden_3d+0": (g3, g3_inp)}
    # demo_3d and bench_3d_1m on the graph path, a rebuild, a density and a
    # force launch a step; the kernel at every lane count on their states
    for label, path, steps in ((f"demo_3d+{LEGACY_3D_STEPS}", DEMO_3D, LEGACY_3D_STEPS),
                               (f"bench_3d_1m+{LEGACY_1M_STEPS}", LARGE_3D, LEGACY_1M_STEPS)):
        solver = tt.WCSPHLegacy(tt.load_scene(path), device=DEVICE)
        start = solver.bind(tt.build_state(solver.scene, device=DEVICE))
        if path == DEMO_3D:
            d3_start, dense = start, legacy_inputs(solver, start)
        reset_counts(kernels)
        end = solver.rollout(start, steps)
        torch.cuda.synchronize()
        counted = {k: kernels[k].launches for k in ("rebuild", "legacy_density", "legacy_force")}
        total = {k: total[k] + kernels[k].launches for k in kernels}
        m = solver.metrics(end)
        print(f"  legacy {label}: {end.num_active} particles, launches {counted}; metrics {m}")
        if counted != dict.fromkeys(counted, steps):
            raise AssertionError(f"legacy {label}: launches {counted}, want {steps} each")
        if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]):
            raise AssertionError(f"legacy {label} unhealthy: {m}")
        states[label] = (solver, legacy_inputs(solver, end))
        del start, end
        errs = {k: max(v, w) for (k, v), w in
                zip(errs.items(), check_legacy(label, *states[label]).values())}
    try:
        legacy_call(legacy, "legacy_density", g, inp, 2)
    except RuntimeError as exc:
        print(f"  lanes=2, a count the kernel is not built for, raises: {exc}")
    else:
        raise AssertionError("the legacy kernel at lanes=2 did not raise")
    states["demo_3d+0"] = (states[f"demo_3d+{LEGACY_3D_STEPS}"][0], dense)
    bounds = {label: legacy_lane_times(label, solver, si, card_line)
              for label, (solver, si) in states.items()}
    bound = bounds[f"demo_2d+{LEGACY_STEPS}"]
    times = time_against_plain({
        mode: (lambda mode=mode: legacy_call(legacy, mode, g, inp),
               lambda mode=mode: legacy_call(neighbors, mode, g, inp), 200, 3)
        for mode in ("legacy_density", "legacy_force")})
    del states, dense, bounds

    graph_turns(tt, "demo_2d legacy", tt.WCSPHLegacy(l2_scene, device=DEVICE),
                tt.WCSPHLegacy(l2_scene, device=DEVICE, graphs=False), sg, None, None,
                LEGACY_TURNS, card_line, R=1)
    d3_scene = tt.load_scene(DEMO_3D)
    graph_turns(tt, "demo_3d legacy", tt.WCSPHLegacy(d3_scene, device=DEVICE),
                tt.WCSPHLegacy(d3_scene, device=DEVICE, graphs=False), d3_start, None, None,
                LEGACY_3D_TURNS, card_line, R=1)
    return total, errs, times, bound, inp["st"].capacity


def row_op_inputs(solver, state, cache=None, react: bool = False) -> dict:
    """The row ops' inputs of one ``solver._apply`` substep on ``state``
    inside the group of ``cache`` (built from ``state`` when None): kernel
    A's density sum, the state (with the substep's volumes under
    ``boundary_mode="per_step"``), the group's sort-time fluid mask and
    flm, and A's force sum (``force_react`` with ``react``, as the coupled
    substep runs it) over the plain packs."""
    from tisph_tpu_torch.models.wcsph import per_step_volumes
    from tisph_tpu_torch.ops.cuda import sweeps
    from tisph_tpu_torch.ops.forces import eos_packs_plain
    from tisph_tpu_torch.ops.neighbors import pack4

    spec, params = solver.spec, solver.params
    if cache is None:
        state, cache = solver._build(state)
    tail = (cache.ids, cache.bounds, cache.material, spec, params, solver.fast_math)
    effm = cache.effm
    if solver.boundary_mode == "per_step":
        delta = sweeps.bvol_sweep(pack4(state.x, cache.boundary.to(torch.float32)), *tail)
        volume, effm = per_step_volumes(delta, cache.boundary, state.volume, cache.flm,
                                        params.density0)
        state = dataclasses.replace(state, volume=volume)
    pos = pack4(state.x, effm)
    rho = sweeps.density_sweep(pos, *tail)
    _, _, vel, aux = eos_packs_plain(rho, state, cache.fluid, cache.flm, params)
    force = sweeps.force_react_sweep if react else sweeps.force_sweep
    return {"rho": rho, "st": state, "fluid": cache.fluid, "flm": cache.flm,
            "dv": force(pos, vel, aux, *tail), "params": params}


def with_nan_rows(inp: dict) -> dict:
    """A copy of ``inp`` with NaN and infinite entries in some rows of
    every float input of the row ops: the density sum, the stored density
    (on non-fluid rows, which keep it), v, x, dv and the mass."""
    st = inp["st"]
    fl = torch.nonzero(st.fluid_mask & inp["fluid"]).flatten()
    rows = fl[torch.linspace(0, fl.numel() - 1, 8, device=fl.device).long()].tolist()
    other = torch.nonzero(~inp["fluid"]).flatten()[:2].tolist()
    rho, dv = inp["rho"].clone(), inp["dv"].clone()
    x, v, density, mass = st.x.clone(), st.v.clone(), st.density.clone(), st.mass.clone()
    nan, inf = float("nan"), float("inf")
    rho[rows[:2]] = nan
    rho[rows[2]] = inf
    density[other] = nan
    v[rows[3], 0] = nan
    x[rows[4], -1] = nan
    dv[rows[5]] = nan
    dv[rows[6], 0] = -inf
    mass[rows[7]] = nan
    st = dataclasses.replace(st, x=x, v=v, density=density, mass=mass)
    return inp | {"rho": rho, "dv": dv, "st": st}


def check_row_ops(label: str, inp: dict) -> dict[str, float]:
    """eos_pack and advance (csrc/pointwise.cu) against eos_packs_plain
    and advance_plain on ``inp`` and on its copy with NaN rows: every
    output bitwise equal (NaNs in the same words).  Returns each kernel's
    max abs difference over the outputs finite on both sides."""
    from tisph_tpu_torch.ops import forces
    from tisph_tpu_torch.ops.cuda import pointwise

    err = {k: 0.0 for k in ROW_OPS}
    for case, c in (("", inp), (" with NaN rows", with_nan_rows(inp))):
        args = (c["rho"], c["st"], c["fluid"], c["flm"], c["params"])
        got, want = pointwise.eos_pack(*args), forces.eos_packs_plain(*args)
        pairs = {("eos_pack", k): (g, w) for k, g, w in zip(("rho", "pressure", "vel", "aux"),
                                                             got, want)}
        adv = (c["st"], got[0], got[1], c["dv"], c["params"])
        g_st, w_st = pointwise.advance(*adv), forces.advance_plain(*adv)
        pairs |= {("advance", k): (getattr(g_st, k), getattr(w_st, k)) for k in ("x", "v")}
        torch.cuda.synchronize()
        for (kern, name), (g, w) in pairs.items():
            differ = _bits(g) != _bits(w)
            if differ.any():
                idx = torch.nonzero(differ)[:4].tolist()
                raise AssertionError(
                    f"{label}{case}: {kern} {name} differs from its plain version in "
                    f"{int(differ.sum())} words, e.g. at {idx}: kernel "
                    f"{[float(g[tuple(i)]) for i in idx]} plain {[float(w[tuple(i)]) for i in idx]}")
            fin = torch.isfinite(g) & torch.isfinite(w)
            if fin.any():
                err[kern] = max(err[kern], float((g[fin] - w[fin]).abs().max()))
        bad = sum(int((~torch.isfinite(g)).sum()) for g, _ in pairs.values())
        print(f"  {label}{case}: {c['st'].capacity} rows, eos_pack and advance bitwise equal to "
              f"their plain versions in every output ({bad} non-finite words)")
    return err


def row_op_bound(kern: str, inp: dict) -> tuple[float, str]:
    """The least time of ``kern`` on ``inp``: each row's bytes (rho from
    the sum on sort-time fluid rows and the stored one elsewhere, 4 bytes
    a row either way; dv on fluid rows only) against its operations."""
    st, params = inp["st"], inp["params"]
    n, dim = st.v.shape
    if kern == "eos_pack":
        exact = int(params.reference_exact)  # reads the material only then
        nbytes = n * (4 + 1 + 4 + 4 + 4 * dim + 4 * exact) + n * (4 + 4 + 16 + 16)
        ops = n * (EOS_FLOPS_PER_ROW + exact)
    else:
        n_fl = int(st.fluid_mask.sum())
        nbytes = n * (2 * 4 * dim + 4) + n_fl * 4 * dim + n * 2 * 4 * dim
        ops = n_fl * ADVANCE_FLOPS_PER_FLUID_ROW[dim]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_pair(tt, path: str, layout: str, R: int):
    """The scene on a solver with the graph path (the default) and on one
    with ``graphs=False``; the start state bound and the bodies (None
    without dynamic ones), which both start from."""
    scene = tt.load_scene(path)
    g, state, rigid = tt.make_solver(scene, tt.build_state(scene, device=DEVICE), device=DEVICE,
                                     resort_every=R, layout=layout)
    e, _, _ = tt.make_solver(scene, state, device=DEVICE, resort_every=R, layout=layout,
                             graphs=False)
    if not (g.graphs and not e.graphs):
        raise AssertionError(f"{path}: graphs {g.graphs} / {e.graphs}, want True / False")
    return g, e, state, rigid


def same_bits(label: str, got, want) -> None:
    """Every field of two states (or two rigid states) bitwise equal."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        same = (torch.equal(_bits(a), _bits(b)) if isinstance(a, torch.Tensor) else a == b)
        if not same:
            raise AssertionError(f"{label}: {f.name} differs between graphs=True and "
                                 "graphs=False")


def graph_path(tt, kernels, card_line: str):
    """Phase 23: each R-group one CUDA graph replay against the eager
    loop (graphs=False): bitwise equal on three paths, with launch counts
    that count replays; a graph rollout queued behind the spin; then both
    paths in turns on three scenes.  Returns the graph runs' launches."""
    total = {k: 0 for k in kernels}
    for label, path, layout, R, steps in GRAPH_BITWISE:
        g, e, state, rigid = graph_pair(tt, path, layout, R)
        sweeps = ((("linear.density", "linear.force") if layout == "linear"
                   else ("sweep.density", "sweep.bvol", "sweep.force_react") if rigid is not None
                   else ("sweep.density", "sweep.force")))
        (got, got_rigid, _), (want, want_rigid, _), counted = graph_against_eager(
            kernels, f"{label}, {steps} steps", lambda: tt.advance(g, state, rigid, steps),
            lambda: tt.advance(e, state, rigid, steps),
            {"rebuild": -(-steps // R)} | {k: steps for k in sweeps})
        print(f"  {label}: {g._runner.captures} captures in {g._runner.capture_seconds:.3f} s")
        same_bits(label, got, want)
        if rigid is not None:
            same_bits(f"{label} bodies", got_rigid, want_rigid)
        print(f"  {label}: graphs=True bitwise equal to graphs=False in every field"
              + (" and every body field" if rigid is not None else ""))
        total = {k: total[k] + counted[k] for k in kernels}
        if label == "demo_3d R=2":
            demo, demo_state = g, got
    assert_no_host_wait(f"demo_3d, a {GRAPH_NO_WAIT}-step graph rollout",
                        lambda: demo.rollout(demo_state, GRAPH_NO_WAIT))
    del g, e, state, demo, demo_state

    for label, path, steps in GRAPH_TURNS:
        g, e, state, rigid = graph_pair(tt, path, "seg", 2)
        graph_turns(tt, label, g, e, state, rigid, None, steps, card_line)
        del g, e, state, rigid
    return total


def graph_turns(tt, label: str, g, e, state, rigid, ems, steps: int, card_line: str,
                queue=None, R: int = 2) -> None:
    """The graph solver ``g`` (nothing captured yet) and the eager ``e``
    from ``state`` (with ``rigid`` and ``ems`` where not None) at R:
    the memory peak of each path's first group over the start's, one
    untimed run of ``steps`` on the graph path (it captures every key the
    run meets), then ``steps`` steps of each in turns (eager, graph, graph,
    eager): particle-steps/s and host ms a step to queue; then the profile
    of each path (device operations, busy ms and idle share a step) and
    the capture's seconds.  ``queue(solver, steps)``, where a call ends in
    a host read (the rectangle's), queues the groups alone: its host ms a
    step are printed for each path."""
    from tisph_tpu_torch.bench import profile_steps

    n = g._num_particles(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.max_memory_allocated()
    tt.advance(e, state, rigid, 2, ems)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    base, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    tt.advance(g, state, rigid, 2, ems)  # warm-up, capture, one replay
    torch.cuda.synchronize()
    graph_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - held
    tt.advance(g, state, rigid, steps, ems)
    rates = {}
    for name, solver in (("eager", e), ("graph", g), ("graph", g), ("eager", e)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.advance(solver, state, rigid, steps, ems)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.setdefault(name, []).append((n * steps / wall, host * 1e3 / steps))
    prof = {name: profile_steps(solver, state, rigid, ems, GRAPH_PROFILE, R)
            for name, solver in (("eager", e), ("graph", g))}
    for name in ("eager", "graph"):
        (pps_a, host_a), (pps_b, host_b) = rates[name]
        p = prof[name]
        print(f"  turns {label} {name}: {pps_a:.6e} / {pps_b:.6e} particle-steps/s, host "
              f"{host_a:.4f} / {host_b:.4f} ms a step to queue, {steps} steps; profile "
              f"({GRAPH_PROFILE} steps): {p['device_ops_per_step']:.1f} device operations, "
              f"{p['device_busy_ms_per_step']:.4f} ms busy, idle share "
              f"{p['device_idle_share']:.4f}, wall {p['wall_ms_per_step']:.4f} ms a step; "
              f"on {card_line}")
    for name, solver in (("eager", e), ("graph", g)) if queue is not None else ():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        queue(solver, steps)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        print(f"  turns {label} {name}: host {host * 1e3 / steps:.4f} ms a step to queue "
              f"the groups alone (without the call's one read), {steps} steps")
    print(f"  turns {label}: {n} particles; {g._runner.captures} captures (warm-up and "
          f"capture) {g._runner.capture_seconds:.4f} s; peak memory over the start's "
          f"max_memory_allocated: eager group {eager_peak / 2**20:.1f} MiB, first graph "
          f"group {graph_peak / 2**20:.1f} MiB (the warm-up's copies, the buffers and the "
          f"capture); still allocated after it +{held / 2**20:.1f} MiB (the buffers and "
          f"what the capture keeps); on {card_line}")


def launch_counts(kernels) -> dict[str, int]:
    """Every kernel's launches and, where it has them, its launches over
    part of the arrays (``<name>.part``)."""
    return {k: f.launches for k, f in kernels.items()} | {
        f"{k}.part": f.part_launches for k, f in kernels.items() if hasattr(f, "part_launches")}


def graph_against_eager(kernels, label: str, run_graph, run_eager, expect: dict):
    """``run_graph()`` and ``run_eager()`` from the same start, each with
    the launch counters at 0: both must count ``expect`` (the part
    launches too); returns both outputs and the graph run's counts."""
    out, counts = [], []
    for run in (run_graph, run_eager):
        reset_counts(kernels)
        out.append(run())
        torch.cuda.synchronize()
        counts.append(launch_counts(kernels))
    full = {k: 0 for k in counts[0]} | expect
    full = with_row_ops(full)
    print(f"  {label}: launches {counts[0]} (graph), equal on the eager path: "
          f"{counts[0] == counts[1]}")
    if counts[0] != full or counts[1] != full:
        raise AssertionError(f"{label}: launch counts {counts[0]} (graph), {counts[1]} (eager), "
                             f"expected {full}")
    return out[0], out[1], counts[0]


def emit_rect_graphs(tt, kernels, e_scene, e_start, ems0, scene, r_scene, card_line: str):
    """Phase 24: ``rollout_emit`` on one device and the rectangle's groups
    as graph replays against the eager loop (graphs=False), bitwise, with
    launch counts that count replays; an emitting graph group and a 2x2
    graph group behind the spin; then both paths in turns on the emitter
    scene and on 2x2.  Returns the graph runs' launches."""
    from tisph_tpu_torch.models.solver_base import SolverBase
    from tisph_tpu_torch.parallel import ShardedWCSPHRect, make_mesh2d, make_mesh3d

    total = {k: 0 for k in kernels}

    def add(counted):
        for k in kernels:
            total[k] += counted[k]

    # the emitter scene: 3 emissions in 300 steps, each on a group's first
    # substep
    g = tt.WCSPH(e_scene, device=DEVICE, resort_every=2)
    e = tt.WCSPH(e_scene, device=DEVICE, resort_every=2, graphs=False)
    start = g.bind(e_start)
    e.bind(start)
    steps = EMIT_GRAPH_STEPS
    groups = steps // 2
    (got, got_ems), (want, want_ems), counted = graph_against_eager(
        kernels, f"bench_3d_mesh_500k rollout_emit, {steps} steps at R=2",
        lambda: g.rollout_emit(start, ems0, steps), lambda: e.rollout_emit(start, ems0, steps),
        {"rebuild": groups, "sweep.density": steps, "sweep.force": steps})
    add(counted)
    same_bits("bench_3d_mesh_500k rollout_emit", got, want)
    es, es_e = got_ems[0], want_ems[0]
    cadence = emission_cadence(ems0[0], start.num_active, start.capacity, steps)
    keys = sorted(map(str, g._runner._graphs))
    print(f"  emitter: graph {es.step} steps, {es.emitted} emitted, num_active "
          f"{got.num_active}; eager {es_e.step}, {es_e.emitted}, {want.num_active}; host "
          f"cadence {cadence}; {g._runner.captures} captures in "
          f"{g._runner.capture_seconds:.3f} s, keys {keys}")
    if ((es.step, es.emitted) != (es_e.step, es_e.emitted)
            or (got.num_active, es.emitted) != cadence or es.emitted != 3 * es.batch_size):
        raise AssertionError("rollout_emit: the graph path's emitter counters or num_active "
                             "differ from the eager path's or from the host's cadence")
    if g._runner.captures != len(keys) or len(keys) > 3:
        raise AssertionError(f"rollout_emit: {g._runner.captures} captures for keys {keys}")
    print("  bench_3d_mesh_500k rollout_emit: graphs=True bitwise equal to graphs=False in "
          "every field")
    assert_no_host_wait("bench_3d_mesh_500k, one emitting graph group",
                        lambda: g.rollout_emit(start, ems0, 2))
    captures = g._runner.captures
    more, more_ems = g.rollout_emit(got, got_ems, steps)
    torch.cuda.synchronize()
    print(f"  {steps} more steps: {more_ems[0].emitted} emitted in all, "
          f"{g._runner.captures} captures")
    if g._runner.captures != captures or more_ems[0].emitted != 6 * es.batch_size:
        raise AssertionError("the captures grew with the emissions")
    del g, e, got, want, more

    # the rectangle: demo_3d on 2x2 and 2x2x2, bench_3d_rigid coupled on 2x2
    rect = None
    d_start = tt.build_state(scene, device=DEVICE)
    for shape in ((2, 2), (2, 2, 2)):
        d = math.prod(shape)
        label = "x".join(map(str, shape))
        make = make_mesh2d if len(shape) == 2 else make_mesh3d
        g = ShardedWCSPHRect(scene, make(*shape, devices=[DEVICE] * d), resort_every=2)
        e = ShardedWCSPHRect(scene, make(*shape, devices=[DEVICE] * d), resort_every=2,
                             graphs=False)
        sg, se = g.bind(d_start), e.bind(d_start)
        steps, groups = RECT_GRAPH_STEPS, RECT_GRAPH_STEPS // 2
        got, want, counted = graph_against_eager(
            kernels, f"demo_3d on {label}, {steps} steps at R=2",
            lambda: g.rollout(sg, steps), lambda: e.rollout(se, steps),
            {"rebuild": groups * d, "csr_bounds": groups * d, "sweep.density": steps * d,
             "sweep.force": steps * d, "sweep.density.part": steps * d,
             "sweep.force.part": steps * d})
        add(counted)
        for s, (a, b) in enumerate(zip(got, want)):
            same_bits(f"{label} shard {s}", a, b)
        if not (torch.equal(g._flags, e._flags) and torch.equal(g._counts, e._counts)):
            raise AssertionError(f"{label}: the flags or live-row counts differ")
        print(f"  demo_3d on {label}: graphs=True bitwise equal to graphs=False in every "
              f"field of every shard, flags {g._flags.tolist()} equal; {g._runner.captures} "
              f"captures in {g._runner.capture_seconds:.3f} s")
        if len(shape) == 2:
            rect = (g, got)
    g, shards = rect
    assert_no_host_wait("2x2, one graph group (its build and two substeps)",
                        lambda: SolverBase._groups(g, (shards,), 2, 2, g._substep))
    waits = count_host_waits(lambda: g.rollout(shards, 2))
    print(f"  2x2: host reads in one graph rollout call: {waits}")
    if waits != 1:
        raise AssertionError(f"2x2 graph rollout call: {waits} host waits, want 1")
    del rect, g, e, shards, got, want

    r_start = tt.build_state(r_scene, device=DEVICE)
    g = ShardedWCSPHRect(r_scene, make_mesh2d(2, 2, devices=[DEVICE] * 4), resort_every=2)
    e = ShardedWCSPHRect(r_scene, make_mesh2d(2, 2, devices=[DEVICE] * 4), resort_every=2,
                         graphs=False)
    sg, se = g.bind(r_start), e.bind(r_start)
    rg = g.init_rigid(sg)
    steps, groups = RECT_GRAPH_STEPS, RECT_GRAPH_STEPS // 2
    sweeps = ("sweep.bvol", "sweep.density", "sweep.force_react")
    (got, got_rg), (want, want_rg), counted = graph_against_eager(
        kernels, f"bench_3d_rigid coupled on 2x2, {steps} steps at R=2",
        lambda: g.rollout_coupled(sg, rg, steps), lambda: e.rollout_coupled(se, rg, steps),
        {"rebuild": groups * 4, "csr_bounds": groups * 4}
        | {k: steps * 4 for k in sweeps} | {f"{k}.part": steps * 4 for k in sweeps})
    add(counted)
    for s, (a, b) in enumerate(zip(got, want)):
        same_bits(f"coupled 2x2 shard {s}", a, b)
    same_bits("coupled 2x2 bodies", got_rg, want_rg)
    print(f"  bench_3d_rigid coupled on 2x2: graphs=True bitwise equal to graphs=False in "
          f"every field of every shard and every body field; {g._runner.captures} captures")
    del g, e, sg, se, got, want

    # both paths in turns: the emitter scene, 2x2 (and, at half the steps,
    # 2x2x2 and the coupled 2x2)
    g = tt.WCSPH(e_scene, device=DEVICE, resort_every=2)
    e = tt.WCSPH(e_scene, device=DEVICE, resort_every=2, graphs=False)
    start = g.bind(e_start)
    e.bind(start)
    graph_turns(tt, "bench_3d_mesh_500k (emitting)", g, e, start, None, ems0,
                EMIT_GRAPH_STEPS, card_line)
    del g, e, start
    for label, sc, start, shape, steps in (
            ("demo_3d on 2x2", scene, d_start, (2, 2), RECT_GRAPH_STEPS),
            ("demo_3d on 2x2x2", scene, d_start, (2, 2, 2), RECT_GRAPH_STEPS // 2),
            ("bench_3d_rigid coupled on 2x2", r_scene, r_start, (2, 2), RECT_GRAPH_STEPS // 2)):
        make = make_mesh2d if len(shape) == 2 else make_mesh3d
        mesh = [DEVICE] * math.prod(shape)
        g = ShardedWCSPHRect(sc, make(*shape, devices=mesh), resort_every=2)
        e = ShardedWCSPHRect(sc, make(*shape, devices=mesh), resort_every=2, graphs=False)
        sg = g.bind(start)
        e.bind(start)
        rigid = g.init_rigid(sg) if sc is r_scene else None
        substep = g._coupled_substep if rigid is not None else g._substep

        def queue(solver, k, sg=sg, rigid=rigid, substep=substep):
            carry = (sg,) if rigid is None else (sg, rigid)
            SolverBase._groups(solver, carry, k, 2, getattr(solver, substep.__name__))

        graph_turns(tt, label, g, e, sg, rigid, None, steps, card_line, queue)
        del g, e, sg
    return total


def slab_flags(sh) -> tuple[int, int]:
    """A slab solver's (halo flag, seam-guard trips), one read."""
    return tuple(torch.stack([sh.occ_halo, sh.occ_resort]).tolist())


def steered_run(label: str, sh, shards, steps: int, chunk: int, card_line: str):
    """``sh.run(shards, steps, check_every=chunk, verbose=True)`` on the
    graph path; each chunk that captured or steered (``_after_chunk``) is
    printed with what it changed and the captures it made.  Returns the
    end shards."""
    runner_of = lambda: sh._runner  # noqa: E731
    after = sh._after_chunk
    seen = {"chunk": 0, "captures": 0}

    def knobs():
        if hasattr(sh, "cap_h"):
            return {"shard_rows": sh.shard_rows, "cap_h": list(sh.cap_h),
                    "cap_m": list(sh.cap_m), "cuts": sh._cuts_made}
        return {"halo": sh.halo, "halo_path": sh.halo_path, "resort_edge": sh.resort_edge,
                "resort": sh.resort}

    def hook(carry, k, verbose, **kw):
        seen["chunk"] += 1
        caps = runner_of().captures
        before = knobs()
        out = after(carry, k, verbose, **kw)
        now = knobs()
        changed = {key: (before[key], now[key]) for key in now if before[key] != now[key]}
        if changed or caps > seen["captures"]:
            print(f"  {label}: chunk {seen['chunk']} ({k} steps): {caps - seen['captures']} "
                  f"captures in it; steering after it: {changed or 'none'}")
        seen["captures"] = caps
        return out

    sh._after_chunk = hook
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = sh.run(shards, steps, check_every=chunk, verbose=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del sh._after_chunk
    n = sum(st.num_active for st in shards)
    print(f"  {label}: {steps} steps in {wall:.3f} s, {n * steps / wall:.6e} particle-steps/s "
          f"over the run (captures included), {sh._runner.captures} captures in "
          f"{sh._runner.capture_seconds:.3f} s; on {card_line}")
    return shards


def slab_emit_graphs(tt, kernels, e_scene, e_start, ems0, scene, r_scene, soak_m: dict,
                     card_line: str):
    """Phase 25: the slab solver's groups and both decompositions'
    ``rollout_emit`` as graph replays against the eager loop
    (graphs=False), bitwise, with launch counts that count replays and the
    seam guard's trips counted on the device; both paths in turns; the
    global branch's cost alone; then demo_3d 10,000 steps through
    ``ShardedWCSPH.run`` on 2 slabs and ``ShardedWCSPHRect.run`` on 2x2 on
    the graph path.  Returns the graph runs' launches."""
    from tisph_tpu_torch.geometry.emitter import EMITTER_OBJECT_ID
    from tisph_tpu_torch.ops import grid as gridops
    from tisph_tpu_torch.parallel import ShardedWCSPH, ShardedWCSPHRect, make_mesh, make_mesh2d

    total = {k: 0 for k in kernels}

    def slab(sc, d, **kw):
        mesh = make_mesh(devices=[DEVICE] * d)
        g, e = ShardedWCSPH(sc, mesh, **kw), ShardedWCSPH(sc, mesh, graphs=False, **kw)
        if not (g.graphs and g.eager_loop is None and not e.graphs):
            raise AssertionError(f"slab on one card: graphs {g.graphs} / {e.graphs}")
        return g, e

    def rect(sc, **kw):
        mesh = make_mesh2d(2, 2, devices=[DEVICE] * 4)
        return (ShardedWCSPHRect(sc, mesh, resort_every=2, **kw),
                ShardedWCSPHRect(sc, mesh, resort_every=2, graphs=False, **kw))

    def both(label, g, e, run_g, run_e, expect):
        """Each path from the same start with the counters and flags at 0;
        ``expect(path, trips)`` gives the launches each must count."""
        out, counts, trips = [], [], []
        for sol, run in ((g, run_g), (e, run_e)):
            sol.reset_flags()
            reset_counts(kernels)
            out.append(run())
            torch.cuda.synchronize()
            counts.append(launch_counts(kernels))
            trips.append(int(sol.occ_resort) if hasattr(sol, "occ_resort") else 0)
        for path, c, t in (("graph", counts[0], trips[0]), ("eager", counts[1], trips[1])):
            want = {k: 0 for k in c} | expect(path, t)
            want = with_row_ops(want)
            if c != want:
                raise AssertionError(f"{label}: {path} launch counts {c}, expected {want}")
        print(f"  {label}: launches {counts[0]} (graph), {counts[1]} (eager); seam-guard "
              f"trips {trips[0]} on the device, {trips[1]} on the eager loop's host")
        if trips[0] != trips[1]:
            raise AssertionError(f"{label}: the device counted {trips[0]} trips, the eager "
                                 f"loop {trips[1]}")
        for k in kernels:
            total[k] += counts[0][k]
        return out[0], out[1], trips[0]

    def slab_expect(d, steps, R, sweeps, part=()):
        groups = -(-steps // R)

        def expect(path, fb):
            rebuild = groups * (d + 1) if path == "graph" else (groups - fb) * d + fb
            return ({"rebuild": rebuild, "csr_bounds": groups * d}
                    | {k: steps * d for k in sweeps} | {f"{k}.part": steps * d for k in part})
        return expect

    def same_shards(label, got, want):
        for s, (a, b) in enumerate(zip(got, want)):
            same_bits(f"{label} shard {s}", a, b)

    # bitwise: demo_3d on 2 and 4 slabs at R=2, linear on 2 at R=1, the
    # coupled 2 slabs, a shuffled start that trips the seam guard
    d_start = tagged(tt.build_state(scene, device=DEVICE))
    steps = SLAB_GRAPH_STEPS
    for d in (2, 4):
        g, e = slab(scene, d, resort_every=2)
        sg, se = g.bind(d_start), e.bind(d_start)
        got, want, _ = both(f"demo_3d on {d} slabs, {steps} steps at R=2", g, e,
                            lambda: g.rollout(sg, steps), lambda: e.rollout(se, steps),
                            slab_expect(d, steps, 2, ("sweep.density", "sweep.force")))
        same_shards(f"{d} slabs", got, want)
        if slab_flags(g) != slab_flags(e):
            raise AssertionError(f"{d} slabs: flags {slab_flags(g)} / {slab_flags(e)}")
        print(f"  demo_3d on {d} slabs: graphs=True bitwise equal to graphs=False in every "
              f"field of every shard, flags {slab_flags(g)} equal; {g._runner.captures} "
              f"captures in {g._runner.capture_seconds:.3f} s")
        if d == 2:
            assert_no_host_wait("2 slabs, one graph group (both resorts and two substeps)",
                                lambda: g.rollout(got, 2))
            waits = count_host_waits(lambda: g.rollout(got, 2))
            print(f"  2 slabs: host reads in one graph rollout call: {waits}")
            if waits:
                raise AssertionError(f"2 slabs graph rollout call: {waits} host waits")
        del g, e, sg, se, got, want

    g, e = slab(scene, 2, layout="linear")
    sg, se = g.bind(d_start), e.bind(d_start)
    n = SLAB_LINEAR_STEPS
    got, want, _ = both(f"demo_3d linear on 2 slabs, {n} steps at R=1", g, e,
                        lambda: g.rollout(sg, n), lambda: e.rollout(se, n),
                        slab_expect(2, n, 1, ("linear.density", "linear.force"),
                                    ("linear.density", "linear.force")))
    same_shards("linear 2 slabs", got, want)
    print("  demo_3d linear on 2 slabs: graphs=True bitwise equal to graphs=False")
    del g, e, sg, se, got, want

    r_start = tt.build_state(r_scene, device=DEVICE)
    g, e = slab(r_scene, 2, resort_every=2)
    sg, se = g.bind(r_start), e.bind(r_start)
    rg = g.init_rigid(sg)
    sweeps = ("sweep.bvol", "sweep.density", "sweep.force_react")
    (got, got_rg), (want, want_rg), _ = both(
        f"bench_3d_rigid coupled on 2 slabs, {steps} steps at R=2", g, e,
        lambda: g.rollout_coupled(sg, rg, steps), lambda: e.rollout_coupled(se, rg, steps),
        slab_expect(2, steps, 2, sweeps))
    same_shards("coupled 2 slabs", got, want)
    same_bits("coupled 2 slabs bodies", got_rg, want_rg)
    print("  bench_3d_rigid coupled on 2 slabs: graphs=True bitwise equal to graphs=False in "
          "every field of every shard and every body field")
    del g, e, sg, se, got, want

    g, e = slab(scene, 2, resort_every=2, resort_edge=128)
    sg = g.bind(d_start)
    e.bind(d_start)
    whole = g.gather_state(sg)
    perm = torch.randperm(whole.capacity, generator=torch.Generator().manual_seed(7)).to(DEVICE)
    shuffled = g.shard_state(dataclasses.replace(
        whole, **{k: getattr(whole, k)[perm] for k in gridops.state_fields(whole)}))
    n = SLAB_TRIP_STEPS
    got, want, trips = both(f"demo_3d on 2 slabs from a shuffled start, edge 128, {n} steps",
                            g, e, lambda: g.rollout(shuffled, n), lambda: e.rollout(shuffled, n),
                            slab_expect(2, n, 2, ("sweep.density", "sweep.force")))
    same_shards("shuffled 2 slabs", got, want)
    if trips < 1:
        raise AssertionError("the shuffled start did not trip the seam guard")
    print(f"  the seam guard tripped {trips} times: graphs=True (both resorts, the global one "
          "selected on the device) bitwise equal to graphs=False (its early return)")
    del g, e, sg, got, want, shuffled, whole

    # the cost of the global branch alone, and of the exchange's, per group
    for d in (2, 4):
        g, _ = slab(scene, d, resort_every=2)
        sg = g.rollout(g.bind(d_start), 20)
        # few repetitions: every call's launches must queue inside cuda_ms's
        # spin, or the host's pace is timed
        order_ms = cuda_ms(lambda: g._exchange_order(sg), 5)
        exch_ms = cuda_ms(lambda: g._exchange_gather(sg, g._exchange_order(sg)[0]), 5)
        glob_ms = cuda_ms(lambda: g._global_resort(sg), 5)
        resort_ms = cuda_ms(lambda: g._resort(sg), 5)
        # a whole group: the carry copied in, one replay, the carry cloned out
        group_ms = cuda_ms(lambda: g.rollout(sg, 2), 5)
        print(f"  resort on {d} slabs (demo_3d after 20 steps), device ms a group: exchange "
              f"{exch_ms:.4f} (its order and guard {order_ms:.4f}), global branch alone "
              f"{glob_ms:.4f}, both and the select (the graph path's _resort) {resort_ms:.4f}; "
              f"at R=2 the global branch adds {glob_ms / 2:.4f} ms a step; a whole R=2 graph "
              f"group (copy in, replay, clone out) {group_ms:.4f}; on {card_line}")
        del g, sg

    # rollout_emit: bench_3d_mesh_500k on 2 slabs and on 2x2
    n = EMIT_GRAPH_STEPS
    es0 = ems0[0]
    g, e = slab(e_scene, 2, resort_every=2)
    sg, se = g.bind(e_start), e.bind(e_start)
    (got, got_ems), (want, want_ems), _ = both(
        f"bench_3d_mesh_500k rollout_emit on 2 slabs, {n} steps at R=2", g, e,
        lambda: g.rollout_emit(sg, ems0, n), lambda: e.rollout_emit(se, ems0, n),
        slab_expect(2, n, 2, ("sweep.density", "sweep.force")))
    same_shards("emitting 2 slabs", got, want)
    cadence = emission_cadence(es0, e_start.num_active, g._capacity(sg), n)
    live = sum(st.num_active for st in got)
    if ((got_ems[0].step, got_ems[0].emitted) != (want_ems[0].step, want_ems[0].emitted)
            or (live, got_ems[0].emitted) != cadence or got_ems[0].emitted != 3 * es0.batch_size
            or [st.num_active for st in got] != [st.num_active for st in want]):
        raise AssertionError("emitting 2 slabs: the emitter counters or live rows differ")
    whole = g.gather_state(got)
    emitted_rows = int((whole.object_id[whole.active_mask] == EMITTER_OBJECT_ID).sum())
    print(f"  emitting 2 slabs: graphs=True bitwise equal to graphs=False; {got_ems[0].emitted} "
          f"emitted ({emitted_rows} live rows of the emitter), num_active {live} (host cadence "
          f"{cadence}); {g._runner.captures} captures, keys {sorted(map(str, g._runner._graphs))}")
    assert_no_host_wait("2 slabs, one emitting graph group", lambda: g.rollout_emit(sg, ems0, 2))
    del g, e, sg, se, got, want, whole

    def rect_expect(steps):
        groups = -(-steps // 2)
        sw = ("sweep.density", "sweep.force")
        return lambda path, fb: ({"rebuild": groups * 4, "csr_bounds": groups * 4}
                                 | {k: steps * 4 for k in sw}
                                 | {f"{k}.part": steps * 4 for k in sw})

    g, e = rect(e_scene)
    sg, se = g.bind(e_start), e.bind(e_start)
    (got, got_ems), (want, want_ems), _ = both(
        f"bench_3d_mesh_500k rollout_emit on 2x2, {n} steps at R=2", g, e,
        lambda: g.rollout_emit(sg, ems0, n), lambda: e.rollout_emit(se, ems0, n),
        rect_expect(n))
    same_shards("emitting 2x2", got, want)
    if not (torch.equal(g._flags, e._flags) and torch.equal(g._counts, e._counts)
            and got_ems[0].emitted == want_ems[0].emitted == 3 * es0.batch_size
            and [st.num_active for st in got] == [st.num_active for st in want]):
        raise AssertionError("emitting 2x2: flags, live rows or emitter counters differ")
    print(f"  emitting 2x2: graphs=True bitwise equal to graphs=False, flags "
          f"{g._flags.tolist()} and live rows {g._counts.tolist()} equal; "
          f"{got_ems[0].emitted} emitted; {g._runner.captures} captures, keys "
          f"{sorted(map(str, g._runner._graphs))}")
    waits = count_host_waits(lambda: g.rollout_emit(got, got_ems, 2))
    print(f"  emitting 2x2: host reads in one graph rollout_emit call: {waits}")
    if waits != 1:
        raise AssertionError(f"emitting 2x2 graph call: {waits} host waits, want 1")
    rows = g.shard_rows
    counts = g._counts.tolist()
    lin = g._shard_of(gridops.cell_coords(es0.seeds_x, g.spec))[0]
    owned = [int((lin == s).sum()) for s in range(4)]
    del g, e, sg, se, got, want

    # a room test that refuses: the busiest owner shard has room for one batch
    frac = (max(c + k for c, k in zip(counts, owned) if k > 0) + 1) / rows
    g, e = rect(e_scene, emit_frac=frac)
    sg, se = g.bind(e_start), e.bind(e_start)
    (got, got_ems), (want, want_ems), _ = both(
        f"bench_3d_mesh_500k rollout_emit on 2x2, emit_frac {frac:.6f}, {n} steps", g, e,
        lambda: g.rollout_emit(sg, ems0, n), lambda: e.rollout_emit(se, ems0, n),
        rect_expect(n))
    same_shards("refusing 2x2", got, want)
    em_g, em_e = got_ems[0].emitted, want_ems[0].emitted
    if not (em_g == em_e < 3 * es0.batch_size
            and [st.num_active for st in got] == [st.num_active for st in want]
            and sum(st.num_active for st in got) == e_start.num_active + em_g):
        raise AssertionError(f"refusing 2x2: emitted {em_g} / {em_e}, live rows differ")
    print(f"  refusing 2x2 (live rows {counts}, seeds owned {owned}, {rows} rows a shard): "
          f"{em_g // es0.batch_size} of 3 due batches fired on both paths, num_active "
          f"{sum(st.num_active for st in got)} equal, every field bitwise equal")
    del g, e, sg, se, got, want

    # both paths in turns
    for label, sc, start, d, ems, turn_steps in (
            ("demo_3d on 2 slabs", scene, d_start, 2, None, 200),
            ("demo_3d on 4 slabs", scene, d_start, 4, None, 100),
            ("bench_3d_mesh_500k on 2 slabs (emitting)", e_scene, e_start, 2, ems0, n)):
        g, e = slab(sc, d, resort_every=2)
        sg = g.bind(start)
        e.bind(start)
        graph_turns(tt, label, g, e, sg, None, ems, turn_steps, card_line)
        del g, e, sg
    g, e = rect(e_scene)
    sg = g.bind(e_start)
    e.bind(e_start)

    def queue(solver, k):
        from tisph_tpu_torch.models.solver_base import SolverBase
        SolverBase._groups(solver, (sg, list(ems0)), k, 2, solver._substep,
                           emit=solver._maybe_emit)

    graph_turns(tt, "bench_3d_mesh_500k on 2x2 (emitting)", g, e, sg, None, ems0, n, card_line,
                queue)
    del g, e, sg

    # the long runs on the graph path
    print(f"  long runs, {SOAK_STEPS} steps in chunks of {SHARD_LONG_CHUNK} at R=2, each "
          "chunk's steering and the captures it made:")
    plain = tt.build_state(scene, device=DEVICE)
    ends = {}
    # the rectangle at a balance_slack of 2.5: at the default 1.5 its third
    # rebalance (after 6,000 steps) found a shard of 97,901 particles for
    # 80,384 rows and raised, as tisph_tpu's rebalance does; a quantile cut
    # leaves a shard at most about half the particles
    for label, sh in (("demo_3d on 2 slabs", ShardedWCSPH(scene, make_mesh(
                          devices=[DEVICE] * 2), resort_every=2)),
                      ("demo_3d on 2x2", ShardedWCSPHRect(scene, make_mesh2d(
                          2, 2, devices=[DEVICE] * 4), resort_every=2,
                          balance_slack=RECT_LONG_SLACK))):
        shards = sh.bind(plain)
        print(f"  {label}: {sh.shard_rows} rows a shard")
        reset_counts(kernels)
        shards = steered_run(label, sh, shards, SOAK_STEPS, SHARD_LONG_CHUNK, card_line)
        got = {k: f.launches for k, f in kernels.items()}
        d = sh.n_shards
        m = sh.metrics(shards)
        print(f"  {label}: launches {got}; metrics {m}")
        if any(got[k] != SOAK_STEPS * d for k in ("sweep.density", "sweep.force") + ROW_OPS):
            raise AssertionError(f"{label}: sweep and row-op launches {got}")
        if (m["nan_count"] != 0 or m["cfl"] >= 1.0 or m["num_active"] != plain.num_active
                or sum(st.num_active for st in shards) != plain.num_active):
            raise AssertionError(f"{label} unhealthy after {SOAK_STEPS} steps: {m}")
        for k in kernels:
            total[k] += got[k]
        ends[label] = m
        del sh, shards
    print("  end states beside phase 20's one-device soak of the same run:")
    for k in ("max_velocity", "cfl", "avg_density_error", "max_density_error"):
        print(f"    {k:<18} " + "  ".join(f"{label} {m[k]:.6f}" for label, m in ends.items())
              + f"  one device {soak_m[k]:.6f}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs "
              "on a CUDA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import tisph_tpu_torch as tt
    from tisph_tpu_torch.ops import forces
    from tisph_tpu_torch.ops import grid as gridops
    from tisph_tpu_torch.ops import neighbors
    from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
    from tisph_tpu_torch.ops.cuda import build
    from tisph_tpu_torch.ops.cuda import legacy as cuda_legacy
    from tisph_tpu_torch.ops.cuda import pointwise as cuda_pointwise
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps

    kernels = {
        "rebuild": cuda_bounds.sort_and_bound,
        "csr_bounds": cuda_bounds.csr_bounds_sorted,
        "sweep.density": cuda_sweeps.density_sweep,
        "sweep.force": cuda_sweeps.force_sweep,
        "sweep.bvol": cuda_sweeps.bvol_sweep,
        "sweep.force_react": cuda_sweeps.force_react_sweep,
        "sweep.reaction": cuda_sweeps.reaction_sweep,
        "linear.density": cuda_sweeps.density_sweep_linear,
        "linear.force": cuda_sweeps.force_sweep_linear,
        "legacy_density": cuda_legacy.legacy_density_sweep,
        "legacy_force": cuda_legacy.legacy_force_sweep,
        "eos_pack": cuda_pointwise.eos_pack,
        "advance": cuda_pointwise.advance,
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
    print("  CUDAGraph.begin_capture_to_if_node (a conditional graph node): "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")

    phase("2 build")
    path, secs = build.build()
    build.load()
    print(f"  {path.name}: nvcc {secs:.2f} s")

    phase("3 rebuild kernel vs sort_state_by_cell + csr_bounds, bounds-only vs searchsorted")
    scene = tt.load_scene(DEMO_3D)
    solver = tt.WCSPH(scene, device=DEVICE, resort_every=2)
    state = solver.bind(tt.build_state(scene, device=DEVICE))
    spec = solver.spec
    rebuild_err = check_rebuild("demo_3d+0", state, spec)
    for path in (LARGE_3D, RIGID_3D):
        sc = tt.load_scene(path)
        sp = tt.WCSPH(sc, device=DEVICE).spec
        label = os.path.basename(path)[:-5] + "+0"
        rebuild_err = max(rebuild_err, check_rebuild(label, tt.build_state(sc, device=DEVICE), sp))
    g2_scene = tt.scene_from_dict(GOLDEN["2d_dam_break"][0])
    rebuild_err = max(rebuild_err, check_rebuild(
        "golden_2d", tt.build_state(g2_scene, device=DEVICE), tt.WCSPH(g2_scene).spec))
    padded = tt.build_state(scene, device=DEVICE, extra_capacity=1500)
    rebuild_err = max(rebuild_err, check_rebuild("demo_3d+1504 inactive", padded, spec))
    dead = dataclasses.replace(state, material=torch.full_like(state.material, -1))
    rebuild_err = max(rebuild_err, check_rebuild("all inactive", dead, spec))
    one = tt.SimState(**{k: getattr(state, k)[:1].clone() for k in gridops.state_fields(state)},
                      num_active=1)
    rebuild_err = max(rebuild_err, check_rebuild("one particle", one, spec))
    # 10,000 particles in one cell (the cell size is 4 radii), the rest as they are
    gen = torch.Generator(device="cpu").manual_seed(1)
    crowd = 0.5 + 0.015 * torch.rand((10_000, 3), generator=gen).to(DEVICE)
    x = torch.cat([crowd, state.x[10_000:]])
    rebuild_err = max(rebuild_err, check_rebuild(
        "crowded cell", dataclasses.replace(state, x=x), spec,
        min_largest=10_000))
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
    check_sweeps("golden_3d", g_solver, g_inp)
    d_inp = sweep_inputs(solver, state)  # demo_3d's dense start state, timed in phase 5
    check_sweeps("demo_3d", solver, d_inp)

    phase(f"5 main path: demo_3d, {STEPS_R2} steps at R=2, {STEPS_R1} at R=1")
    n = state.num_active
    d_start = state  # demo_3d's start state, for the rebuild's times
    state = solver.rollout(state, 2)  # warm-up, outside the counted run
    assert_no_host_wait("demo_3d, one R=2 group", lambda: solver.rollout(state, 2))
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
    zero = {k: 0 for k in kernels if k not in ("rebuild", "sweep.density", "sweep.force")}
    want_r2 = {"rebuild": groups, "sweep.density": STEPS_R2, "sweep.force": STEPS_R2} | zero
    want_r2 = with_row_ops(want_r2)
    total = STEPS_R2 + STEPS_R1
    want = {"rebuild": groups + STEPS_R1, "sweep.density": total,
            "sweep.force": total} | zero
    want = with_row_ops(want)
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

    evolved = f"demo_3d+{STEPS_R2 + STEPS_R1 + 2}"
    rebuild_err = max(rebuild_err, check_rebuild(evolved, state, spec))
    solver.resort_every = 2
    through_kernel = solver.rollout(state, BITWISE_STEPS)
    through_plain = plain_rebuild_rollout(solver, state, BITWISE_STEPS)
    torch.cuda.synchronize()
    for k in gridops.state_fields(state):
        if not torch.equal(_bits(getattr(through_kernel, k)), _bits(getattr(through_plain, k))):
            raise AssertionError(f"{BITWISE_STEPS} steps at R=2 through the rebuild kernel and "
                                 f"through its plain version differ in {k}")
    print(f"  {BITWISE_STEPS} steps at R=2 from {evolved} through rollout (the rebuild kernel) "
          "and through sort_state_by_cell + csr_bounds + _group_cache + _apply: every field "
          "bitwise equal")
    del through_kernel, through_plain
    rebuild = {evolved: rebuild_times(evolved, state, spec),
               "demo_3d+0": rebuild_times("demo_3d+0", d_start, spec)}

    # The boundary-volume mode runs at bind on static boundaries; demo_3d has
    # none, so its launch is checked on the golden 3D scene's bind (the
    # rigid path of phase 7 runs it every substep).
    reset_counts(kernels)
    g_solver2 = tt.WCSPH(g_scene, device=DEVICE)
    g_state = g_solver2.bind(tt.build_state(g_scene, device=DEVICE))
    g_solver2.rollout(g_state, 2)
    torch.cuda.synchronize()
    if cuda_sweeps.bvol_sweep.launches != 1:
        raise AssertionError(f"bvol launches {cuda_sweeps.bvol_sweep.launches} at bind, want 1")

    print("  sweep checks on the evolved demo_3d state:")
    inp = sweep_inputs(solver, state)
    errs = check_sweeps("demo_3d+250", solver, inp)
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
    }
    times = time_against_plain(timing)
    times["rebuild"] = (rebuild[evolved]["ms"], rebuild[evolved]["plain_ms"])
    queries = torch.arange(sp.num_cells + 1, dtype=torch.int32, device=DEVICE)
    library = {"csr_bounds": cuda_ms(lambda: torch.searchsorted(ids, queries, out_int32=True),
                                     200),
               "rebuild": rebuild[evolved]["library_ms"]}
    print(f"  time csr_bounds as one torch.searchsorted call: {library['csr_bounds']:.4f} ms")
    # the bounds kernel reads the ids and writes the bounds; its searches
    # are integer compares, far below the bytes' time
    bound = {"csr_bounds": ((ids.numel() + sp.num_cells + 1) * 4 / HBM_BYTES_PER_S * 1e3,
                            "bytes"),
             "rebuild": rebuild_bound(state, sp)}
    bound |= {f"sweep.{m}": sweep_bound(m, inp, solver) for m in ("density", "force")}
    print("  the same sweeps on demo_3d's dense start state:")
    d_args = (d_inp["pos"], d_inp["ids"], d_inp["bounds"], d_inp["st"].material, sp, pr)
    d_f = (d_inp["pos"], d_inp["vel"], d_inp["aux"], *d_args[1:])
    for name, fn in (("sweep.density", lambda: cuda_sweeps.density_sweep(*d_args)),
                     ("sweep.force", lambda: cuda_sweeps.force_sweep(*d_f))):
        print(f"  time {name:<17} on the dense start state: kernel "
              f"{cuda_ms(fn, 20):.4f} / {cuda_ms(fn, 20):.4f} ms")
    for m in ("density", "force"):
        sweep_bound(m, d_inp, solver)

    phase("6 golden trajectories (R=1)")
    for name, (raw, steps) in GOLDEN.items():
        for fast in (False, True):
            if not golden_check(tt, name, raw, steps, fast_math=fast)["ok"]:
                raise AssertionError(f"golden {name} fast_math={fast} outside the "
                                     "test_golden tolerances")

    phase(f"7 rigid main path: bench_3d_rigid, {RIGID_R2} steps at R=2, {RIGID_R1} at R=1")
    r_scene = tt.load_scene(RIGID_3D)
    r_state = tt.build_state(r_scene, device=DEVICE)
    # tag every particle in color[:, 0] (exact in f32 below 2^24; colour
    # plays no part in the physics) to follow the body's particles
    tags_all = torch.arange(r_state.capacity, dtype=torch.float32, device=DEVICE)
    r_state = dataclasses.replace(r_state, color=torch.cat(
        [tags_all[:, None], r_state.color[:, 1:]], dim=1))
    r_solver, r_state, rigid = tt.make_solver(r_scene, r_state, device=DEVICE, resort_every=2)
    if not isinstance(r_solver, tt.WCSPHRigid):
        raise AssertionError(f"bench_3d_rigid dispatched {type(r_solver).__name__}")
    sel0 = (r_state.object_id == 0) & r_state.boundary_mask
    tags = r_state.color[sel0, 0]
    d0 = torch.linalg.vector_norm(r_state.x[sel0] - rigid.com[0], dim=1)
    com_y0 = float(rigid.com[0, 1])
    rn = r_state.num_active
    print(f"  {rn} particles ({int(r_state.fluid_mask.sum())} fluid, "
          f"{int(sel0.sum())} body) capacity {r_state.capacity}, com_y {com_y0:.6f}")
    r_state, rigid = r_solver.rollout_coupled(r_state, rigid, 2)  # warm-up, not counted
    assert_no_host_wait("bench_3d_rigid, one coupled R=2 group",
                        lambda: r_solver.rollout_coupled(r_state, rigid, 2))
    reset_counts(kernels)
    t0 = time.perf_counter()
    r_state, rigid = r_solver.rollout_coupled(r_state, rigid, RIGID_R2)
    torch.cuda.synchronize()
    rwall2 = time.perf_counter() - t0
    r_solver.resort_every = 1
    t0 = time.perf_counter()
    r_state, rigid = r_solver.rollout_coupled(r_state, rigid, RIGID_R1)
    torch.cuda.synchronize()
    rwall1 = time.perf_counter() - t0
    r_launches = {k: f.launches for k, f in kernels.items()}
    r_steps = RIGID_R2 + RIGID_R1
    r_want = {k: 0 for k in kernels} | {
        "rebuild": -(-RIGID_R2 // 2) + RIGID_R1, "sweep.density": r_steps,
        "sweep.bvol": r_steps, "sweep.force_react": r_steps}
    r_want = with_row_ops(r_want)
    if r_launches != r_want:
        raise AssertionError(f"rigid launch counts {r_launches}, expected {r_want}")
    m = r_solver.metrics(r_state)
    drift = body_drift(r_state, rigid, tags, d0)
    com = rigid.com[0].tolist()
    print(f"  launches: {r_launches}")
    print(f"  metrics: {m}")
    print(f"  body: com {com} v_com {rigid.v_com[0].tolist()} omega {rigid.omega[0].tolist()} "
          f"shape drift {drift:.3e} (< 1e-4)")
    if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
        raise AssertionError(f"rigid path unhealthy: {m}")
    if not drift < 1e-4:
        raise AssertionError(f"body shape drift {drift:.3e} >= 1e-4")
    if not (all(math.isfinite(c) for c in com) and com[1] < com_y0):
        raise AssertionError(f"sphere com {com} did not fall from com_y {com_y0}")
    rpps2, rpps1 = rn * RIGID_R2 / rwall2, rn * RIGID_R1 / rwall1
    print(f"  {rn} particles: R=2 {rpps2:.6e} particle-steps/s "
          f"({rwall2 * 1e3 / RIGID_R2:.4f} ms/step), R=1 {rpps1:.6e} particle-steps/s "
          f"({rwall1 * 1e3 / RIGID_R1:.4f} ms/step) on {card_line}")

    r_label = f"bench_3d_rigid+{RIGID_R2 + RIGID_R1 + 2}"
    rebuild_err = max(rebuild_err, check_rebuild(r_label, r_state, r_solver.spec))
    rebuild[r_label] = rebuild_times(r_label, r_state, r_solver.spec)
    print("  sweep checks on the final bench_3d_rigid state (volumes from a fresh bvol pass):")
    r_inp = sweep_inputs(r_solver, r_state, per_step=True)
    # every mode this path runs, at this path's shapes: bvol, density and
    # (on the fluid rows) force, then force_react and reaction
    r_errs = check_sweeps("rigid+1602", r_solver, r_inp)
    errs |= check_coupling_sweeps("rigid+1602", r_solver, r_inp)
    # the JSON's entries of the modes whose launches come from this run
    # take their error and time from this run's state too
    errs["bvol"] = r_errs["bvol"]
    launches |= {k: r_launches[k] for k in ("sweep.bvol", "sweep.force_react", "sweep.reaction")}
    launches |= {k: launches[k] + r_launches[k] for k in ROW_OPS}
    r_st, r_ids, r_bnd = r_inp["st"], r_inp["ids"], r_inp["bounds"]
    r_args = (r_inp["pos"], r_inp["vel"], r_inp["aux"], r_ids, r_bnd,
              r_st.material, r_solver.spec, r_solver.params)
    r_bvol = (r_inp["pos_b"], r_ids, r_bnd, r_st.material, r_solver.spec, r_solver.params)
    r_dens = (r_inp["pos"], *r_bvol[1:])
    times |= time_against_plain({
        "sweep.bvol": (lambda: cuda_sweeps.bvol_sweep(*r_bvol),
                       lambda: neighbors.bvol_sweep(*r_bvol), 50, 5),
        "sweep.force_react": (lambda: cuda_sweeps.force_react_sweep(*r_args),
                              lambda: neighbors.force_react_sweep(*r_args), 20, 2),
        "sweep.reaction": (lambda: cuda_sweeps.reaction_sweep(*r_args),
                           lambda: neighbors.reaction_sweep(*r_args), 20, 2),
        # this path's density launch (printed only; the kernels line has
        # demo_3d's)
        "density@rigid": (lambda: cuda_sweeps.density_sweep(*r_dens),
                          lambda: neighbors.density_sweep(*r_dens), 20, 2),
        # what the boundary family and fast_math cost force_react on this
        # state (printed only; not in the kernels line)
        "force@rigid": (lambda: cuda_sweeps.force_sweep(*r_args),
                        lambda: neighbors.force_sweep(*r_args), 20, 2),
        "force_react exact": (lambda: cuda_sweeps.force_react_sweep(*r_args, False),
                              lambda: neighbors.force_react_sweep(*r_args), 20, 2),
    })
    bound |= {f"sweep.{m}": sweep_bound(m, r_inp, r_solver)
              for m in ("bvol", "force_react", "reaction")}
    for m in ("density", "force"):
        sweep_bound(m, r_inp, r_solver)

    phase(f"8 buoyancy: test_buoyancy's box in a pool, {BUOYANCY_STEPS} steps at R=1")
    with tempfile.TemporaryDirectory() as tmp:
        light = buoyancy(tt, 200.0, tmp)
        heavy = buoyancy(tt, 5000.0, tmp)
    if not light > 0.27:
        raise AssertionError(f"light body (density 200) should float, com_y={light}")
    if not heavy < 0.27:
        raise AssertionError(f"heavy body (density 5000) should sink, com_y={heavy}")

    phase(f"9 linear main path: demo_3d, {LINEAR_STEPS} steps at R=1, layout=linear")
    l_solver = tt.WCSPH(scene, device=DEVICE, layout="linear")
    l_state = l_solver.bind(tt.build_state(scene, device=DEVICE))
    l_state = l_solver.rollout(l_state, 2)  # warm-up, outside the counted run
    assert_no_host_wait("demo_3d linear, one step", lambda: l_solver.rollout(l_state, 1))
    reset_counts(kernels)
    t0 = time.perf_counter()
    l_state = l_solver.rollout(l_state, LINEAR_STEPS)
    torch.cuda.synchronize()
    lwall = time.perf_counter() - t0
    l_launches = {k: f.launches for k, f in kernels.items()}
    l_want = {k: 0 for k in kernels} | {"rebuild": LINEAR_STEPS,
                                        "linear.density": LINEAR_STEPS,
                                        "linear.force": LINEAR_STEPS}
    l_want = with_row_ops(l_want)
    if l_launches != l_want:
        raise AssertionError(f"linear launch counts {l_launches}, expected {l_want}")
    m = l_solver.metrics(l_state)
    print(f"  launches: {l_launches}")
    print(f"  metrics: {m}")
    if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
        raise AssertionError(f"linear path unhealthy: {m}")
    print(f"  {n} particles: R=1 {n * LINEAR_STEPS / lwall:.6e} particle-steps/s "
          f"({lwall * 1e3 / LINEAR_STEPS:.4f} ms/step) on {card_line}")
    launches |= {k: l_launches[k] for k in ("linear.density", "linear.force")}
    launches |= {k: launches[k] + l_launches[k] for k in ROW_OPS}

    print("  linear kernel checks on the evolved demo_3d state:")
    l_inp = sweep_inputs(l_solver, l_state)
    lin_errs = check_linear_sweeps(f"demo_3d+{LINEAR_STEPS + 2}", l_solver, l_inp)
    l_st, l_ids, l_bnd = l_inp["st"], l_inp["ids"], l_inp["bounds"]
    l_d = (l_inp["pos"], l_ids, l_bnd, l_st.material, l_solver.spec, l_solver.params)
    l_f = (l_inp["pos"], l_inp["vel"], l_inp["aux"], l_ids, l_bnd, l_st.material,
           l_solver.spec, l_solver.params)
    times |= time_against_plain({
        "linear.density": (lambda: cuda_sweeps.density_sweep_linear(*l_d),
                           lambda: neighbors.density_sweep_linear(*l_d), 20, 2),
        "linear.force": (lambda: cuda_sweeps.force_sweep_linear(*l_f),
                         lambda: neighbors.force_sweep_linear(*l_f), 20, 2),
        # the seg kernel on the same state (printed only)
        "seg density@lin": (lambda: cuda_sweeps.density_sweep(*l_d),
                            lambda: neighbors.density_sweep(*l_d), 20, 2),
        "seg force@lin": (lambda: cuda_sweeps.force_sweep(*l_f),
                          lambda: neighbors.force_sweep(*l_f), 20, 2),
    })
    bound |= {f"linear.{m}": sweep_bound(m, l_inp, l_solver, seg=False)
              for m in ("density", "force")}

    print("  linear kernel checks on demo_3d's dense start state:")
    s_inp = sweep_inputs(l_solver, l_solver.bind(tt.build_state(scene, device=DEVICE)))
    check_linear_sweeps("demo_3d+0", l_solver, s_inp, min_chunks=2)
    s_d = (s_inp["pos"], s_inp["ids"], s_inp["bounds"], s_inp["st"].material,
           l_solver.spec, l_solver.params)
    s_f = (s_inp["pos"], s_inp["vel"], s_inp["aux"], *s_d[1:])
    for name, fn in (
            ("linear.density", lambda: cuda_sweeps.density_sweep_linear(*s_d)),
            ("linear.force", lambda: cuda_sweeps.force_sweep_linear(*s_f)),
            ("seg density@lin", lambda: cuda_sweeps.density_sweep(*s_d)),
            ("seg force@lin", lambda: cuda_sweeps.force_sweep(*s_f))):
        print(f"  time {name:<17} on the dense start state: kernel "
              f"{cuda_ms(fn, 20):.4f} / {cuda_ms(fn, 20):.4f} ms")

    print("  linear kernel checks on a lattice at 0.63 of the radius spacing:")
    m_scene = tt.scene_from_dict(MANY_CHUNKS)
    m_solver = tt.WCSPH(m_scene, device=DEVICE, layout="linear")
    m_state = m_solver.bind(tt.build_state(m_scene, device=DEVICE))
    # seeded velocities, so the viscosity terms of the force are not all 0
    gen = torch.Generator(device="cpu").manual_seed(0)
    m_state = dataclasses.replace(m_state, v=m_state.v + 0.5 * torch.randn(
        m_state.v.shape, generator=gen).to(DEVICE))
    check_linear_sweeps("dense_lattice", m_solver, sweep_inputs(m_solver, m_state),
                        min_chunks=8)

    for name, (raw, steps) in GOLDEN.items():
        for fast in (False, True):
            if not golden_check(tt, name, raw, steps, fast_math=fast, layout="linear")["ok"]:
                raise AssertionError(f"golden {name} layout=linear fast_math={fast} outside "
                                     "the test_golden tolerances")

    phase(f"10 large launch: bench_3d_1m, {LARGE_STEPS} steps at R=2")
    b_scene = tt.load_scene(LARGE_3D)
    b_solver = tt.WCSPH(b_scene, device=DEVICE, resort_every=2)
    b_state = b_solver.bind(tt.build_state(b_scene, device=DEVICE))
    b_inp = sweep_inputs(b_solver, b_state)
    b_n = b_state.capacity
    b_shapes = {m: cuda_sweeps.launch_shape(m, b_n) for m in ("density", "force")}
    print(f"  {b_state.num_active} particles, capacity {b_n}; launch shapes {b_shapes}")
    if any(lanes != 1 for lanes, _ in b_shapes.values()):
        raise AssertionError(f"{b_n} rows should launch one thread per row: {b_shapes}")
    reset_counts(kernels)
    t0 = time.perf_counter()
    b_state = b_solver.rollout(b_state, LARGE_STEPS)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    b_launches = {k: f.launches for k, f in kernels.items()}
    b_want = {k: 0 for k in kernels} | {"rebuild": -(-LARGE_STEPS // 2),
                                        "sweep.density": LARGE_STEPS,
                                        "sweep.force": LARGE_STEPS}
    b_want = with_row_ops(b_want)
    if b_launches != b_want:
        raise AssertionError(f"bench_3d_1m launch counts {b_launches}, expected {b_want}")
    m = b_solver.metrics(b_state)
    print(f"  launches: {b_launches}")
    print(f"  metrics: {m}")
    if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
        raise AssertionError(f"bench_3d_1m unhealthy: {m}")
    print(f"  {b_state.num_active} particles: R=2 "
          f"{b_state.num_active * LARGE_STEPS / bwall:.6e} particle-steps/s "
          f"({bwall * 1e3 / LARGE_STEPS:.4f} ms/step, the first steps from the dense start "
          f"state) on {card_line}")
    rebuild_err = max(rebuild_err, check_rebuild(f"bench_3d_1m+{LARGE_STEPS}", b_state,
                                                 b_solver.spec))
    rebuild[f"bench_3d_1m+{LARGE_STEPS}"] = rebuild_times(f"bench_3d_1m+{LARGE_STEPS}",
                                                          b_state, b_solver.spec, reps=20)
    del b_state
    print("  sweep checks on bench_3d_1m's dense start state (one thread per row):")
    check_sweeps("1m+0", b_solver, b_inp)
    b_d = (b_inp["pos"], b_inp["ids"], b_inp["bounds"], b_inp["st"].material,
           b_solver.spec, b_solver.params)
    b_f = (b_inp["pos"], b_inp["vel"], b_inp["aux"], *b_d[1:])
    b_fl = b_inp["st"].fluid_mask
    for fast in (False, True):
        a_rho = cuda_sweeps.density_sweep(*b_d, fast)
        c_rho = cuda_sweeps.density_sweep_linear(*b_d, fast)
        a_dv = cuda_sweeps.force_sweep(*b_f, fast)
        c_dv = cuda_sweeps.force_sweep_linear(*b_f, fast)
        torch.cuda.synchronize()
        if not torch.equal(c_rho, a_rho):
            raise AssertionError(f"1m+0 linear density fast={fast}: not bitwise equal to the "
                                 "seg kernel's one-lane walk")
        rel = float((c_dv - a_dv).abs().max()) / float(a_dv[b_fl].abs().max())
        print(f"  1m+0 fast_math={int(fast)}: linear density bitwise equal to the seg "
              f"kernel's; force max|err|/max|ref| = {rel:.3e} (atol {TOL[fast][1]})")
        if not rel <= TOL[fast][1]:
            raise AssertionError(f"1m+0 linear force vs seg fast={fast}: {rel:.3e}")
    for name, fn in (("sweep.density", lambda: cuda_sweeps.density_sweep(*b_d)),
                     ("sweep.force", lambda: cuda_sweeps.force_sweep(*b_f)),
                     ("linear.density", lambda: cuda_sweeps.density_sweep_linear(*b_d)),
                     ("linear.force", lambda: cuda_sweeps.force_sweep_linear(*b_f))):
        print(f"  time {name:<17} on bench_3d_1m's dense start state: kernel "
              f"{cuda_ms(fn, 10):.4f} / {cuda_ms(fn, 10):.4f} ms")

    phase(f"11 emitter path: bench_3d_mesh_500k, {EMIT_R2} steps at R=2, {EMIT_R1} at R=1")
    from tisph_tpu_torch import checkpoint
    from tisph_tpu_torch.geometry.emitter import EMITTER_OBJECT_ID, maybe_emit

    e_scene = tt.load_scene(EMIT_3D)
    e_solver = tt.WCSPH(e_scene, device=DEVICE, resort_every=2)
    reset_counts(kernels)
    e_start = e_solver.bind(tt.build_state(e_scene, device=DEVICE))
    e_bind = {k: f.launches for k, f in kernels.items()}
    if e_bind != with_row_ops({k: 0 for k in kernels} | {"rebuild": 1, "sweep.bvol": 1}):
        raise AssertionError(f"emitter scene bind launched {e_bind}: want the rebuild and bvol "
                             "once each")
    ems0 = [tt.make_emitter_state(em, e_scene, DEVICE) for em in e_scene.emitters]
    es0 = ems0[0]
    en0, ecap = e_start.num_active, e_start.capacity
    print(f"  {en0} particles ({int(e_start.fluid_mask.sum())} fluid, "
          f"{int(e_start.boundary_mask.sum())} boundary) capacity {ecap}, grid {e_solver.spec.res}; "
          f"emitter batch {es0.batch_size} every {es0.interval} steps, quota "
          f"{es0.max_particles}")
    t0 = time.perf_counter()
    e_state, ems = e_solver.rollout_emit(e_start, ems0, EMIT_R2)
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    e_solver.resort_every = 1
    e_state, ems = e_solver.rollout_emit(e_state, ems, EMIT_R1)
    torch.cuda.synchronize()
    e_launches = {k: f.launches for k, f in kernels.items()}
    e_steps = EMIT_R2 + EMIT_R1
    e_want = {k: 0 for k in kernels} | {
        "rebuild": 1 + -(-EMIT_R2 // 2) + EMIT_R1, "sweep.bvol": 1,
        "sweep.density": e_steps, "sweep.force": e_steps}
    e_want = with_row_ops(e_want)
    if e_launches != e_want:
        raise AssertionError(f"emitter path launch counts {e_launches}, expected {e_want}")
    if not e_solver.graphs:
        raise AssertionError("the emitter path's solver is not on the graph path")
    print(f"  graph path: {e_solver._runner.captures} captures (one per fire pattern and "
          f"group length) in {e_solver._runner.capture_seconds:.3f} s")
    want_n, want_emitted = emission_cadence(es0, en0, ecap, e_steps)
    es = ems[0]
    emitted_rows = (e_state.object_id == EMITTER_OBJECT_ID)
    m = e_solver.metrics(e_state)
    print(f"  launches: {e_launches}")
    print(f"  metrics: {m}")
    print(f"  emitted {es.emitted} in {es.emitted // es0.batch_size} batches, num_active "
          f"{e_state.num_active} (host cadence: {want_emitted}, {want_n}); emitted rows fluid "
          f"with object_id {EMITTER_OBJECT_ID}: {int((emitted_rows & e_state.fluid_mask).sum())}")
    if (es.emitted, e_state.num_active, es.step) != (want_emitted, want_n, e_steps):
        raise AssertionError(f"emission: emitted {es.emitted}, num_active {e_state.num_active}, "
                             f"step {es.step}; the cadence says {want_emitted}, {want_n}, "
                             f"{e_steps}")
    if want_emitted != 7 * es0.batch_size:
        raise AssertionError(f"{want_emitted} emitted, want 7 batches")
    if int((emitted_rows & e_state.fluid_mask).sum()) != es.emitted or int(
            emitted_rows.sum()) != es.emitted:
        raise AssertionError("the emitted rows are not all fluid rows of the emitter's id")
    if m["nan_count"] != 0 or not math.isfinite(m["max_velocity"]) or m["cfl"] >= 1.0:
        raise AssertionError(f"emitter path unhealthy: {m}")
    e_ms = ewall * 1e3 / EMIT_R2
    print(f"  {en0} to {e_state.num_active} particles: R=2 emitting rollout {e_ms:.4f} ms/step "
          f"({en0 * EMIT_R2 / ewall:.6e} particle-steps/s) on {card_line}")
    launches = {k: launches[k] + e_launches[k] for k in kernels}

    e_solver.resort_every = 2
    if e_steps % es0.interval:
        raise AssertionError("the host-wait group must start on an emitting step")
    assert_no_host_wait("bench_3d_mesh_500k, one R=2 group that emits",
                        lambda: e_solver.rollout_emit(e_state, ems, 2))

    # a group built one substep before an emission: build, a substep that
    # does not emit (step 699), then the emission of step 700 on the second
    vol0 = e_scene.particle_volume0
    g_state, cache = e_solver._build(e_state)
    g_state, es_a = maybe_emit(g_state, dataclasses.replace(es, step=es.step - 1), vol0)
    if es_a.emitted != es.emitted:
        raise AssertionError("the first substep of the captured group emitted")
    g_state = e_solver._apply(g_state, cache)
    na_before = g_state.num_active
    g_state, es_b = maybe_emit(g_state, es_a, vol0)
    new = slice(na_before, g_state.num_active)
    if es_b.emitted != es.emitted + es0.batch_size:
        raise AssertionError("the second substep of the captured group did not emit")
    print(f"  captured state: rows {new.start}:{new.stop} emitted on the group's second "
          "substep, after its rebuild; sweeps with the sort-time material:")
    g_inp = group_inputs(e_solver, g_state, cache)
    e_errs = check_sweeps("emit_mid", e_solver, g_inp)
    kern = e_solver._apply(g_state, cache)
    plain = plain_apply(e_solver, g_state, cache)
    torch.cuda.synchronize()
    b = es0.batch_size
    ballistic = {"v": es.velocity.expand(b, 3), "density": es.density.expand(b),
                 "x": g_state.x[new] + e_solver.params.dt * g_state.v[new]}
    for name, out in (("kernel", kern), ("plain", plain)):
        for k, want in ballistic.items():
            if not torch.equal(getattr(out, k)[new], want):
                raise AssertionError(f"{name} step: the emitted rows' {k} is not ballistic")
    fl = cache.fluid
    dv_ref = neighbors.force_sweep(g_inp["pos"], g_inp["vel"], g_inp["aux"], cache.ids,
                                   cache.bounds, cache.material, e_solver.spec, e_solver.params)
    dv_max = float(dv_ref[fl].abs().max())
    v_err = float((kern.v - plain.v)[fl].abs().max())
    # the force tolerance at fast_math on, through dt and the clamp's 1 + c_f
    v_tol = TOL[True][1] * dv_max * e_solver.params.dt * (1 + e_solver.params.collision_factor)
    rho_err = float(((kern.density - plain.density)[fl].abs() / plain.density[fl]).max())
    x_err = float((kern.x - plain.x).abs().max())
    print(f"  one _apply step, kernel vs plain sweeps: emitted rows' x, v, density bitwise "
          f"equal and ballistic; fluid rows max|dv| {dv_max:.4e}, v max|err| {v_err:.3e} "
          f"(tol {v_tol:.3e}), density max rel err {rho_err:.3e} (rtol {TOL[True][0]}), "
          f"x max|err| {x_err:.3e} (atol 1e-6)")
    if not (v_err <= v_tol and rho_err <= TOL[True][0] and x_err <= 1e-6):
        raise AssertionError("the step through the kernels and through the plain sweeps differ")
    errs["density"] = max(errs["density"], e_errs["density"])
    errs["force"] = max(errs["force"], e_errs["force"])
    emit_mid = (g_state, cache)  # phase 26's emitter state
    del g_inp, kern, plain, dv_ref

    phase(f"12 checkpoint on the card: {CKPT_STEPS} steps at R=2 against "
          f"{CKPT_STEPS // 2} + save_npz + load_npz + {CKPT_STEPS // 2}")
    e_solver.resort_every = 2
    reset_counts(kernels)
    ck_a, ck_ems_a = e_solver.rollout_emit(e_start, ems0, CKPT_STEPS)
    half, ck_half = e_solver.rollout_emit(e_start, ems0, CKPT_STEPS // 2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        checkpoint.save_npz(half, path, emitters=ck_half)
        loaded, ck_loaded = checkpoint.load_npz(path, with_emitters=True, device=DEVICE)
    ck_b, ck_ems_b = e_solver.rollout_emit(loaded, ck_loaded, CKPT_STEPS // 2)
    torch.cuda.synchronize()
    c_launches = {k: f.launches for k, f in kernels.items()}
    c_want = {k: 0 for k in kernels} | {"rebuild": CKPT_STEPS, "sweep.density": 2 * CKPT_STEPS,
                                        "sweep.force": 2 * CKPT_STEPS}
    c_want = with_row_ops(c_want)
    if c_launches != c_want:
        raise AssertionError(f"checkpoint launch counts {c_launches}, expected {c_want}")
    ea_, eb_ = ck_ems_a[0], ck_ems_b[0]
    if (ea_.step, ea_.emitted, ck_a.num_active) != (eb_.step, eb_.emitted, ck_b.num_active):
        raise AssertionError("resumed run's emitter or particle count differs")
    if ea_.emitted != 2 * es0.batch_size:
        raise AssertionError(f"{ea_.emitted} emitted in {CKPT_STEPS} steps, want 2 batches")
    for k in gridops.state_fields(ck_a):
        if not torch.equal(_bits(getattr(ck_a, k)), _bits(getattr(ck_b, k))):
            raise AssertionError(f"the resumed run differs from the uninterrupted one in {k}")
    print(f"  {ck_a.num_active} particles, {ea_.emitted} emitted: every field of the resumed "
          "run bitwise equal to the uninterrupted run's, emitter counters equal; "
          f"launches {c_launches}")
    launches = {k: launches[k] + c_launches[k] for k in kernels}
    del e_state, ck_a, ck_b, half, loaded

    phase(f"13 legacy V1 solver: demo_2d, {LEGACY_STEPS} steps graph vs eager, "
          f"{LEGACY_CHECK} card vs CPU, the kernel vs plain at every lane count on four "
          "states, demo_2d and demo_3d in turns")
    l13, leg_errs, leg_times, leg_bound, leg_rows = legacy_path(tt, kernels, card_line)
    launches = {k: launches[k] + l13[k] for k in kernels}
    times |= leg_times
    bound |= leg_bound

    phase(f"14 sharded demo_3d: {SHARD_STEPS} steps at R=2 on 2 and 4 shards of one card")
    s14, shard_sweeps = sharded_demo(tt, kernels, scene, card_line)
    phase(f"15 sharded bench_3d_rigid: {SHARD_RIGID} coupled steps at R=2 on 2 shards")
    s15 = sharded_rigid(tt, kernels, r_scene, card_line)
    launches = {k: launches[k] + s14[k] + s15[k] for k in kernels}
    phase("16 viewers and utilities on the card: phase 5's demo_3d state")
    viewers_and_utils(solver, scene, state)
    phase(f"17 rectangle decomposition: demo_3d, {RECT_STEPS} steps at R=2 on a 2x2 and a "
          "2x2x2 mesh of one card")
    s17, rect_sweeps, rect_prof = rect_demo(tt, kernels, scene, card_line)
    phase(f"18 rectangle bench_3d_rigid: {RECT_RIGID} coupled steps at R=2 on a 2x2 mesh")
    s18 = rect_rigid(tt, kernels, r_scene, card_line)
    phase(f"19 sharded linear layout: demo_3d, {LIN_SHARD_STEPS} steps at R=1 on 2 and 4 "
          "shards")
    s19, lin_shard = linear_sharded(tt, kernels, scene, card_line)
    launches = {k: launches[k] + s17[k] + s18[k] + s19[k] for k in kernels}
    phase(f"20 long runs: demo_3d {SOAK_STEPS} steps and bench_3d_1m {SOAK_1M_STEPS} at R=2 "
          "through tools.soak")
    s20, soak_errs, soak_m = long_run(tt, kernels, times, card_line)
    phase(f"21 the cadence and the compat gap: compare_resort on demo_3d ({RESORT_STEPS} steps, "
          "R=2 and R=3), compare_compat on demo_2d")
    s21 = cadence_and_compat(kernels, card_line)
    phase(f"22 coupled long runs: the buoyancy scenes through ShardedWCSPH.run_coupled "
          f"({BUOYANCY_STEPS} steps), WCSPHRigid.run_coupled against rollout_coupled")
    s22 = coupled_long_runs(tt, kernels, r_scene, card_line)
    launches = {k: launches[k] + s20[k] + s21[k] + s22[k] for k in kernels}
    phase(f"23 the graph path against graphs=False: bitwise on demo_3d (R=2, R=1 linear) and "
          f"bench_3d_rigid, a graph rollout behind the spin, both paths in turns")
    s23 = graph_path(tt, kernels, card_line)
    launches = {k: launches[k] + s23[k] for k in kernels}
    phase(f"24 rollout_emit and the rectangle as graphs against graphs=False: bitwise on "
          f"bench_3d_mesh_500k ({EMIT_GRAPH_STEPS} steps), demo_3d on 2x2 and 2x2x2 and "
          f"bench_3d_rigid on 2x2 ({RECT_GRAPH_STEPS}), both paths in turns")
    s24 = emit_rect_graphs(tt, kernels, e_scene, e_start, ems0, scene, r_scene, card_line)
    launches = {k: launches[k] + s24[k] for k in kernels}
    phase(f"25 the slab solver and both decompositions' rollout_emit as graphs against "
          f"graphs=False: bitwise on demo_3d (2 and 4 slabs, linear, a tripped seam guard), "
          f"bench_3d_rigid and bench_3d_mesh_500k (2 slabs, 2x2, a refused batch), both paths "
          f"in turns, demo_3d {SOAK_STEPS} steps through run on 2 slabs and 2x2")
    s25 = slab_emit_graphs(tt, kernels, e_scene, e_start, ems0, scene, r_scene, soak_m,
                           card_line)
    launches = {k: launches[k] + s25[k] for k in kernels}
    del e_start

    phase("26 the row ops (csrc/pointwise.cu) vs their plain versions: demo_3d, "
          "bench_3d_rigid, the emitter scene mid-group and the 2D golden start, with NaN rows")
    t26 = time.perf_counter()
    g2_solver = tt.WCSPH(g2_scene, device=DEVICE)
    row_inputs = {
        evolved: row_op_inputs(solver, state),
        r_label: row_op_inputs(r_solver, r_state, react=True),
        "emit_mid": row_op_inputs(e_solver, *emit_mid),
        "golden_2d+0": row_op_inputs(g2_solver,
                                     g2_solver.bind(tt.build_state(g2_scene, device=DEVICE))),
    }
    row_err = {k: 0.0 for k in ROW_OPS}
    for label, inp in row_inputs.items():
        err = check_row_ops(label, inp)
        row_err = {k: max(e, err[k]) for k, e in row_err.items()}
    for label, inp in row_inputs.items():
        eos_args = (inp["rho"], inp["st"], inp["fluid"], inp["flm"], inp["params"])
        adv_args = (inp["st"], *forces.eos_packs_plain(*eos_args)[:2], inp["dv"], inp["params"])
        print(f"  {label}:")
        # 20 calls of the plain sequences (17 and 30 launches each) queue
        # inside cuda_ms's spin: the device's time, not the host's pace
        row_times = time_against_plain({
            "eos_pack": (lambda: cuda_pointwise.eos_pack(*eos_args),
                         lambda: forces.eos_packs_plain(*eos_args), 200, 20),
            "advance": (lambda: cuda_pointwise.advance(*adv_args),
                        lambda: forces.advance_plain(*adv_args), 200, 20)})
        row_bound = {k: row_op_bound(k, inp) for k in ROW_OPS}
        for k in ROW_OPS:
            print(f"  {label} {k}: kernel {row_times[k][0]:.4f} ms, plain sequence "
                  f"{row_times[k][1]:.4f} ms, bound {row_bound[k][0]:.5f} ms "
                  f"({row_bound[k][1]}); on {card_line}")
        if label == evolved:  # the JSON's entries: demo_3d, the main path's state
            times |= row_times
            bound |= row_bound
    print(f"  phase 26: {time.perf_counter() - t26:.1f} s")
    del row_inputs, emit_mid
    print(f"  run_sharded --mesh2d 2x2 --profile 20 (phase 17): "
          f"{rect_prof['device_ops_per_step']:.1f} device operations, "
          f"{rect_prof['device_busy_ms_per_step']:.4f} ms busy, idle share "
          f"{rect_prof['device_idle_share']:.4f}, wall {rect_prof['wall_ms_per_step']:.4f} ms "
          "a step")
    for title, checks in (("kernel A over a shard's rows (phase 14)", shard_sweeps),
                          ("kernel A with an i-row map, 2x2 shard 1 (phase 17)", rect_sweeps),
                          ("kernel C over a shard's row range (phase 19)", lin_shard)):
        print(f"  {title}, ms (kernel, plain, bound):")
        for mode, (err, ms, pms, bms, by) in checks.items():
            print(f"    {mode:<8} {ms:.4f} {pms:.4f} {bms:.5f} ({by}); max|err| {err:.3e}")

    src = {k: ("tisph_tpu_torch/csrc/bounds.cu", "tisph_tpu/ops/pallas/bounds.py:43")
           for k in ("rebuild", "csr_bounds")}
    for k in kernels:
        if k.startswith("sweep."):
            src[k] = ("tisph_tpu_torch/csrc/sweeps.cu", "tisph_tpu/ops/pallas/sweeps.py:787")
        elif k.startswith("linear."):
            src[k] = ("tisph_tpu_torch/csrc/sweeps_linear.cu",
                      "tisph_tpu/ops/pallas/sweeps.py:384")
    # no Pallas kernel: the jnp sweeps of tisph_tpu's legacy step
    src["legacy_density"] = ("tisph_tpu_torch/csrc/legacy.cu",
                             "tisph_tpu/models/wcsph_legacy.py:56")
    src["legacy_force"] = ("tisph_tpu_torch/csrc/legacy.cu", "tisph_tpu/models/wcsph_legacy.py:95")
    # no Pallas kernel: row ops that XLA fuses inside tisph_tpu's seg step
    src["eos_pack"] = ("tisph_tpu_torch/csrc/pointwise.cu", "tisph_tpu/models/wcsph.py:255-264")
    src["advance"] = ("tisph_tpu_torch/csrc/pointwise.cu", "tisph_tpu/models/wcsph.py:283-311")
    err_of = {"rebuild": rebuild_err, "csr_bounds": float(bounds_err)}
    # A's entries fold in its row-range (phase 14) and i-row-map (17)
    # checks and, for density and force, its check on the piled-up state
    # (20); C's its row-range check (19)
    err_of |= {f"sweep.{m}": max([e] + [c[m][0] for c in (shard_sweeps, rect_sweeps) if m in c]
                                 + ([soak_errs[m]] if m in ("density", "force") else []))
               for m, e in errs.items()}
    err_of |= {f"linear.{m}": max(e, lin_shard[m][0]) for m, e in lin_errs.items()}
    err_of |= leg_errs  # demo_2d's evolved state and the 3D golden start
    err_of |= row_err  # phase 26's four states, NaN rows too
    print("  the rebuild pass after the sort, ms (kernel, plain, library, bound):")
    for label, r in rebuild.items():
        print(f"    {label:<22} {r['ms']:.4f} {r['plain_ms']:.4f} {r['library_ms']:.4f} "
              f"{r['bound_ms']:.5f}")
    summary = {"kernels": [
        {"name": k, "route": "cuda", "source": src[k][0], "replaces": src[k][1],
         "launches": launches[k], "max_abs_err": err_of[k],
         "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bound[k][0], "bound_by": bound[k][1], "library_ms": library.get(k)}
        for k in kernels
    ]}
    for entry in summary["kernels"]:  # the legacy kernel's launch rule
        if entry["name"].startswith("legacy_"):
            entry["lanes"] = cuda_legacy.legacy_launch_shape(2, leg_rows)[0]  # demo_2d
            entry["lane_rule"] = {"rows_below": cuda_legacy.LANE_RULE}  # by dim
    print(card_line)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
