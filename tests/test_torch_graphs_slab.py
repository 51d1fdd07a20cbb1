"""The graph runner (``tisph_tpu_torch.models.graphs``) on the slab solver
and on both decompositions' ``rollout_emit``, since the seam guard and the
rectangle's room test are decided on the device.

On the CPU the runner's plumbing, with a direct call of the group in
place of each replay (``GroupRunner(capture=False)``), against the eager
loop (``graphs=False``), every field, flag and counter bitwise:

- ``ShardedWCSPH`` on 2 and 4 CPU-device shards: the seg layout at R=2 and
  R=1, the linear layout and the coupled carry;
- a seam guard made to trip by a shuffled state: the runner runs both
  resorts and selects the global sort's rows, bitwise what the eager
  loop's early return gives, and counts the trip on the device;
- ``occ_halo`` and ``occ_resort`` accumulating and reset in place; a new
  key after ``regrow_halo``, ``regrow_resort_edge`` and the switch to
  ``"global"``; ``run``'s steering through the runner;
- the slab's emission straddling a shard boundary, and the rectangle's
  room test refusing a batch on one shard and a quota stopping mid-call;
- the slab and both emissions through the runner against ``tisph_tpu``'s
  ``ShardedWCSPH`` and ``ShardedWCSPH2D`` on the 8 virtual CPU devices, at
  the tolerances of ``tests/test_torch_parallel.py`` and
  ``tests/test_torch_parallel2d.py``.

Marked ``cuda`` (skipped here): real capture of the slab and of both
emissions against ``graphs=False``, bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tisph_tpu as tt
from tisph_tpu.geometry import emitter as jem
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops.neighbors import SweepConfig
from tisph_tpu.parallel import ShardedWCSPH as JShardedWCSPH
from tisph_tpu.parallel import ShardedWCSPH2D as JShardedWCSPH2D
from tisph_tpu.parallel import make_mesh as jax_mesh
from tisph_tpu.parallel import make_mesh2d as jax_mesh2d

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.graphs import GroupRunner
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.parallel import ShardedWCSPH, ShardedWCSPHRect, make_mesh, make_mesh2d

import test_torch_parallel as tslab
import test_torch_parallel2d as trect
from test_torch_graphs import _direct, _equal

torch.set_num_threads(2)


def _same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal(g, w)


def _slab_scene(n):
    """The bar of ``tests/test_torch_parallel.py`` on 4 shards (interior
    windows cut on both sides), its cube on 2."""
    return pt.scene_from_dict(tslab._slab_raw() if n == 4 else tslab._raw(0.04))


def _pair(scene, n, **kw):
    """An eager slab solver and one whose groups go through the runner,
    each bound to the same start."""
    start = pt.build_state(scene, device="cpu")
    out = []
    for direct in (False, True):
        solver = ShardedWCSPH(scene, tslab._cpu(n), **kw)
        shards = solver.bind(start)
        runner = _direct(solver) if direct else None
        out.append((solver, shards, runner))
    return out


def _flags(solver):
    return int(solver.occ_halo), int(solver.occ_resort)


# -- the slab's groups, bitwise against the eager loop -----------------------------

_SLAB_CASES = {
    "seg R=2, 2 shards": (2, "seg", 2, 5),
    "seg R=2, 4 shards": (4, "seg", 2, 5),
    "seg R=1, 2 shards": (2, "seg", 1, 3),
    "seg R=1, 4 shards": (4, "seg", 1, 3),
    "linear, 2 shards": (2, "linear", 1, 3),
    "linear, 4 shards": (4, "linear", 1, 3),
}


@pytest.mark.parametrize("case", list(_SLAB_CASES))
def test_slab_plumbing_equals_eager(case):
    """``rollout`` through the runner (groups of R, then the tail) against
    the eager loop: every shard's fields and live rows, the halo flag and
    the seam-guard count bitwise, the flags written in place."""
    n, layout, R, steps = _SLAB_CASES[case]
    (eager, e_sh, _), (solver, shards, runner) = _pair(_slab_scene(n), n, resort_every=R,
                                                       layout=layout)
    held = solver._inplace()
    want = eager.rollout(e_sh, steps)
    got = solver.rollout(shards, steps)
    assert set(runner._graphs) == ({(R, None), (steps % R, None)} - {(0, None)})
    _same_shards(got, want)
    assert all(a is b for a, b in zip(solver._inplace(), held))
    assert _flags(solver) == _flags(eager)


@pytest.mark.parametrize("n", [2, 4])
def test_slab_coupled_plumbing_equals_eager(tmp_path, n):
    """``rollout_coupled`` through the runner, 3 steps at R=2: the shards
    and the bodies bitwise the eager loop's."""
    scene = tslab._rigid_raw(tmp_path)
    start = pt.build_state(scene, device="cpu")
    out = []
    for direct in (False, True):
        solver = ShardedWCSPH(scene, tslab._cpu(n), resort_every=2)
        shards = solver.bind(start)
        rigid = solver.init_rigid(shards)
        runner = _direct(solver) if direct else None
        out.append(solver.rollout_coupled(shards, rigid, 3))
    assert runner._base is not None
    _same_shards(out[1][0], out[0][0])
    _equal(out[1][1], out[0][1])


# -- the seam guard on the device -------------------------------------------------

def _shuffled(solver, shards, seed):
    """The shards' rows in a random global order: the exchange's edges
    cannot hold it, so the seam guard trips."""
    whole = solver.gather_state(shards)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(whole.capacity))
    whole = dataclasses.replace(whole, **{k: getattr(whole, k)[perm]
                                          for k in gridops.state_fields(whole)})
    return solver.shard_state(whole)


def test_seam_guard_trip_selects_the_global_sort():
    """A shuffled state on 4 shards with a 128-row edge trips the guard:
    the runner's group (both resorts, the global one selected) equals the
    eager loop's early return and the plain global sort, bitwise, and the
    trip counts on the device; without a trip the selected resort is the
    exchange's."""
    scene = _slab_scene(4)
    (eager, e_sh, _), (solver, shards, _) = _pair(scene, 4, resort_edge=128)
    glob = ShardedWCSPH(scene, tslab._cpu(4), resort="global", resort_edge=128)
    g_sh = glob.bind(pt.build_state(scene, device="cpu"))
    want = eager.step(_shuffled(eager, eager.step(e_sh), 7))
    got = solver.step(_shuffled(solver, solver.step(shards), 7))
    plain = glob.step(_shuffled(glob, glob.step(g_sh), 7))
    _same_shards(got, want)
    _same_shards(got, plain)
    assert _flags(solver) == _flags(eager) and _flags(solver)[1] >= 1

    # no trip: the exchange's rows, as the eager loop's exchange gives them
    solver.occ_resort.zero_()
    eager.occ_resort.zero_()
    _same_shards(solver.step(got), eager.step(want))
    assert _flags(solver) == _flags(eager) == (0, 0)


def test_slab_flags_accumulate_and_reset_in_place():
    """Two shuffled groups trip the guard twice, and a 128-row halo on 2
    shards trips the halo flag: through the runner both add up in the
    tensors the graphs hold as on the eager loop; ``reset_flags`` zeroes
    them in place and the next group counts from 0."""
    runs = []
    for direct in (False, True):
        scene = _slab_scene(2)
        solver = ShardedWCSPH(scene, tslab._cpu(2), halo=128, resort_edge=128)
        shards = solver.bind(pt.build_state(scene, device="cpu"))
        if direct:
            _direct(solver)
        held = solver._inplace()
        shards = solver.step(_shuffled(solver, solver.step(shards), 3))
        shards = solver.step(_shuffled(solver, shards, 4))
        after = _flags(solver)
        solver.reset_flags()
        assert all(a is b for a, b in zip(solver._inplace(), held))
        assert _flags(solver) == (0, 0)
        shards = solver.step(shards)
        runs.append((shards, after, _flags(solver)))
    (want, w2, w1), (got, g2, g1) = runs
    assert w2[0] == 1 and w2[1] >= 2  # the halo flag; a trip on each shuffle
    assert (g2, g1) == (w2, w1)
    _same_shards(got, want)


def test_slab_steering_gives_new_keys():
    """What ``run``'s steering changes is in the key: a deeper halo, a
    deeper edge and the switch to the global sort each give a new one."""
    (_, _, _), (solver, shards, _) = _pair(_slab_scene(4), 4, halo=128, resort_edge=128)
    runner = GroupRunner(solver, capture=False)
    sub = solver._substep
    keys = [runner.key((shards,), 2, sub)]
    assert runner.key((shards,), 2, sub) == keys[0]
    solver.regrow_halo()
    keys.append(runner.key((shards,), 2, sub))
    solver.regrow_resort_edge()
    keys.append(runner.key((shards,), 2, sub))
    solver.resort = "global"
    keys.append(runner.key((shards,), 2, sub))
    assert len(set(keys)) == 4


@pytest.mark.parametrize("steer", ["halo", "edge", "global"])
def test_slab_run_steering_through_runner(steer):
    """``run`` through the runner, bitwise the eager ``run``: a 128-row
    halo on 2 shards deepens; seam-guard trips on most rebuilds deepen the
    edge, and at a saturated edge switch the resort to ``"global"``; each
    steering step is a new key."""
    kw = {"halo": dict(halo=128), "edge": dict(resort_edge=128), "global": {}}[steer]
    out = []
    for direct in (False, True):
        scene = _slab_scene(2)
        solver = ShardedWCSPH(scene, tslab._cpu(2), resort_every=2, **kw)
        shards = solver.bind(pt.build_state(scene, device="cpu"))
        if steer == "global":
            solver.regrow_resort_edge(solver.shard_rows)
        if steer != "halo":
            solver.occ_resort.fill_(10)
        if direct:
            runner = _direct(solver)
            base0 = runner.key((shards,), 0, solver._substep)[:-2]
        got = solver.run(shards, 4, check_every=2)
        out.append((got, solver.halo, solver.resort_edge, solver.resort, _flags(solver)))
    (want, *w), (got, *g) = out
    _same_shards(got, want)
    assert g == w
    changed = {"halo": w[0] > 128, "edge": w[1] > 128, "global": w[2] == "global"}[steer]
    assert changed, w
    assert runner._base != base0


# -- emission on a list of shards -----------------------------------------------------

def _straddle_scene():
    """tests/test_torch_parallel.py's emitter scene with a batch of 400
    seeds every 2 steps, and room for three batches."""
    raw = tslab._emit_raw()
    raw["emitters"][0].update(start=[0.1, 0.8, 0.1], end=[0.9, 0.8001, 0.9], interval=2,
                              maxParticles=0)
    scene = pt.scene_from_dict(raw)
    return scene, pt.build_state(scene, device="cpu", extra_capacity=1200)


@pytest.mark.parametrize("n", [2, 4])
def test_slab_emission_straddles_a_shard_boundary(n):
    """A batch fills global rows [num_active, num_active + b), here across
    a shard boundary (on 2 shards the first batch, on 4 the second and the
    third): through the runner every shard writes its part by a fixed-shape
    scatter from one start row, bitwise the eager loop; the live rows per
    shard follow, and every emitted row is live."""
    scene, start = _straddle_scene()
    es = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
    b, steps = es.batch_size, 6
    out = []
    for direct in (False, True):
        solver = ShardedWCSPH(scene, tslab._cpu(n), resort_every=2)
        shards = solver.bind(start)
        runner = _direct(solver) if direct else None
        out.append(solver.rollout_emit(shards, [es], steps))
    (want, w_ems), (got, g_ems) = out
    rps = solver.shard_rows
    starts = [start.num_active + j * b for j in range(3)]
    assert any(s0 // rps != (s0 + b - 1) // rps for s0 in starts)  # a batch straddles
    _same_shards(got, want)
    _equal(g_ems[0], w_ems[0])
    assert g_ems[0].emitted == 3 * b and g_ems[0].step == steps
    total = start.num_active + 3 * b
    assert [st.num_active for st in got] == [solver._live_rows(total, s) for s in range(n)]
    assert len(runner._starts) == 1  # every batch on a group's first substep
    whole = solver.gather_state(got)
    assert int((whole.object_id[whole.active_mask] == 10_000).sum()) == 3 * b
    assert int(whole.active_mask.sum()) == total and bool(torch.isfinite(whole.x).all())


# (emit_frac, max_particles, emitted batches in 12 steps): on the 2x2 mesh
# shard 3 holds 300 of 640 rows and owns 30 of a batch's 36 seeds, so a
# share of 340 rows lets one batch fire and refuses the next on shard 3
# alone; a quota of two batches stops the third
_ROOM_CASES = {"one shard refuses": (340 / 640, 256, 1),
               "quota stops mid-call": (0.9, 72, 2)}


@pytest.mark.parametrize("case", list(_ROOM_CASES))
def test_rect_room_test_refuses_a_batch(case):
    """The rectangle's room test and quota on the device, through the
    runner, against the eager loop: every shard, its live rows, the flags,
    the live-row counts and the emitter's counters bitwise, and the
    emitted batches as the case says."""
    frac, quota, batches = _ROOM_CASES[case]
    raw = trect._emit_raw()
    raw["emitters"][0]["maxParticles"] = quota
    scene, start = trect._start(raw, extra_capacity=512)
    es = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
    out = []
    for direct in (False, True):
        solver = ShardedWCSPHRect(scene, trect._mesh((2, 2)), resort_every=2, emit_frac=frac)
        shards = solver.bind(start)
        runner = _direct(solver) if direct else None
        got, ems = solver.rollout_emit(shards, [es], 12)
        out.append((got, ems, solver._counts.clone(), solver._flags.clone()))
    (want, w_ems, w_counts, w_flags), (got, g_ems, g_counts, g_flags) = out
    _same_shards(got, want)
    _equal(g_ems[0], w_ems[0])
    assert torch.equal(g_counts, w_counts) and torch.equal(g_flags, w_flags)
    assert g_ems[0].step == 12 and g_ems[0].emitted == batches * es.batch_size
    assert sum(st.num_active for st in got) == start.num_active + g_ems[0].emitted
    # the keys are the due pattern (steps 0, 5, 10: a group's first and
    # second substeps), whatever fired
    assert {p for _, p in runner._graphs} == {None, (False, ((True,), (False,))),
                                              (False, ((False,), (True,)))}


# -- against tisph_tpu ------------------------------------------------------------------

@pytest.mark.parametrize("n", [2])
def test_slab_through_runner_matches_jax(n):
    """tests/test_torch_parallel.py's parity with tisph_tpu's ShardedWCSPH
    (its CPU sweeps), through the runner, 5 steps at R=1 on 2 shards (the
    emitter case below runs 4)."""
    raw = tslab._raw(0.04)
    scene, state, start = tslab._tagged_start(raw)
    js = JShardedWCSPH(scene, jax_mesh(n))
    jst = js.bind(state)
    for _ in range(5):
        jst = js.step(jst)
    solver = ShardedWCSPH(pt.scene_from_dict(raw), tslab._cpu(n))
    shards = solver.bind(pt.state_from_host(start, "cpu"))
    runner = _direct(solver)
    shards = solver.rollout(shards, 5)
    assert set(runner._graphs) == {(1, None)}
    tslab._close(pt.state_to_host(solver.gather_state(shards)),
                 jax_to_host(jax.device_get(jst)))


def test_slab_emit_through_runner_matches_jax():
    """tests/test_parallel.py:113's emitter on 4 shards (maybe_emit, then a
    step, 12 times: batches at steps 0, 5 and 10) against the port's R=1
    ``rollout_emit`` through the runner."""
    raw = tslab._emit_raw()
    scene, state, start = tslab._tagged_start(raw)
    jstate = tt.build_state(scene, extra_capacity=256)
    jstate = dataclasses.replace(jstate, object_id=jnp.arange(jstate.capacity, dtype=jnp.int32))
    js = JShardedWCSPH(scene, jax_mesh(4))
    jst = js.bind(jstate)
    jes = jem.make_emitter_state(scene.emitters[0], scene)
    emit = jax.jit(lambda s, e: jem.maybe_emit(s, e, scene.particle_volume0))
    for _ in range(12):
        jst, jes = emit(jst, jes)
        jst = js.step(jst)
    pscene = pt.scene_from_dict(raw)
    solver = ShardedWCSPH(pscene, tslab._cpu(4))
    shards = solver.bind(pt.state_from_host(jax_to_host(jstate), "cpu"))
    runner = _direct(solver)
    pes = pt.make_emitter_state(pscene.emitters[0], pscene, "cpu")
    shards, (pes,) = solver.rollout_emit(shards, [pes], 12)
    assert runner._base is not None
    assert pes.emitted == int(jes.emitted) == 3 * pes.batch_size
    got, want = pt.state_to_host(solver.gather_state(shards)), jax_to_host(jax.device_get(jst))
    # emitted rows share object_id 10,000: match them by position
    for host in (got, want):
        live = host["material"] != -1
        em = live & (host["object_id"] == 10_000)
        order = np.lexsort(np.round(host["x"][em] / 2e-3).T[::-1])
        host["object_id"][np.flatnonzero(em)[order]] = 10_000 + np.arange(em.sum())
    tslab._close(got, want)


def test_rect_emit_through_runner_matches_jax():
    """tests/test_parallel2d.py:318's emitter on a 2x2 mesh: tisph_tpu's
    ShardedWCSPH2D ``rollout_emit`` (its seg kernel in interpret mode, R=2,
    6 steps: batches at steps 0 and 5, its pmin room test) against the
    port's through the runner, at tests/test_torch_parallel2d.py's
    tolerances."""
    raw = trect._emit_raw()
    jscene = tt.scene_from_dict(raw)
    jstate = tt.build_state(jscene, extra_capacity=512)
    tags = jnp.arange(jstate.capacity, dtype=jnp.float32)
    jstate = dataclasses.replace(jstate, color=jstate.color.at[:, 0].set(tags))
    js = JShardedWCSPH2D(jscene, jax_mesh2d(2, 2),
                         sweep_cfg=SweepConfig(**trect._JCFG, resort_every=2))
    jes = jem.make_emitter_state(jscene.emitters[0], jscene)
    jst, (jes,) = js.rollout_emit(js.bind(jstate), [jes], 6)
    want = trect._jax_live(jax.device_get(jst))
    scene, start = trect._start(raw, extra_capacity=512)
    solver = ShardedWCSPHRect(scene, trect._mesh((2, 2)), resort_every=2)
    shards = solver.bind(start)
    runner = _direct(solver)
    pes = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
    shards, (pes,) = solver.rollout_emit(shards, [pes], 6)
    assert runner._base is not None
    assert pes.emitted == int(jax.device_get(jes.emitted)) == 2 * pes.batch_size
    trect._close(solver.gather_state(shards), want)


# -- on the card -----------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured on the card only")


@pytest.mark.cuda
def test_slab_replay_equals_eager_on_cuda(tmp_path):
    """Real capture: the slab on 2 and 4 shards of one card (seg at R=2, 5
    steps; linear at R=1, 3), the coupled carry on 2 shards (3 steps) and a
    shuffled state that trips the seam guard, each bitwise
    ``graphs=False`` with its flags."""
    _need_cuda()
    for n in (2, 4):
        scene = _slab_scene(n)
        start = pt.build_state(scene, device="cuda")
        for layout, R, steps in (("seg", 2, 5), ("linear", 1, 3)):
            out = []
            for graphs in (False, None):
                solver = ShardedWCSPH(scene, make_mesh(devices=["cuda:0"] * n),
                                      resort_every=R, layout=layout, graphs=graphs)
                out.append((solver.rollout(solver.bind(start), steps), _flags(solver)))
            assert solver.graphs and solver._runner.captures == len(solver._runner._graphs)
            _same_shards(out[1][0], out[0][0])
            assert out[1][1] == out[0][1]
    scene = _slab_scene(4)
    out = []
    for graphs in (False, None):
        solver = ShardedWCSPH(scene, make_mesh(devices=["cuda:0"] * 4), resort_edge=128,
                              graphs=graphs)
        shards = solver.step(solver.bind(pt.build_state(scene, device="cuda")))
        out.append((solver.step(_shuffled(solver, shards, 7)), _flags(solver)))
    _same_shards(out[1][0], out[0][0])
    assert out[1][1] == out[0][1] and out[1][1][1] >= 1
    r_scene = tslab._rigid_raw(tmp_path)
    r_start = pt.build_state(r_scene, device="cuda")
    out = []
    for graphs in (False, None):
        solver = ShardedWCSPH(r_scene, make_mesh(devices=["cuda:0"] * 2), resort_every=2,
                              graphs=graphs)
        shards = solver.bind(r_start)
        out.append(solver.rollout_coupled(shards, solver.init_rigid(shards), 3))
    _same_shards(out[1][0], out[0][0])
    _equal(out[1][1], out[0][1])


@pytest.mark.cuda
def test_sharded_emit_replay_equals_eager_on_cuda():
    """Real capture: the slab's straddling emission on 2 shards and the
    rectangle's refused batch on 2x2, bitwise ``graphs=False``."""
    _need_cuda()
    scene, start = _straddle_scene()
    start = pt.state_from_host(pt.state_to_host(start), "cuda")
    es = pt.make_emitter_state(scene.emitters[0], scene, "cuda")
    out = []
    for graphs in (False, None):
        solver = ShardedWCSPH(scene, make_mesh(devices=["cuda:0"] * 2), resort_every=2,
                              graphs=graphs)
        out.append(solver.rollout_emit(solver.bind(start), [es], 6))
    _same_shards(out[1][0], out[0][0])
    _equal(out[1][1][0], out[0][1][0])
    frac, quota, batches = _ROOM_CASES["one shard refuses"]
    raw = trect._emit_raw()
    scene = pt.scene_from_dict(raw)
    start = pt.build_state(scene, device="cuda", extra_capacity=512)
    es = pt.make_emitter_state(scene.emitters[0], scene, "cuda")
    out = []
    for graphs in (False, None):
        solver = ShardedWCSPHRect(scene, make_mesh2d(2, 2, devices=["cuda:0"] * 4),
                                  resort_every=2, emit_frac=frac, graphs=graphs)
        out.append(solver.rollout_emit(solver.bind(start), [es], 12))
    _same_shards(out[1][0], out[0][0])
    _equal(out[1][1][0], out[0][1][0])
    assert out[1][1][0].emitted == batches * es.batch_size
