"""The graph runner (``tisph_tpu_torch.models.graphs``) on the two paths
that replay since emission and the rectangle decomposition joined it.

On the CPU the runner's plumbing, with a direct call of the group in
place of each replay (``GroupRunner(capture=False)``), against the eager
loop (``graphs=False``), every field, counter and flag bitwise:

- ``rollout_emit`` on one device at R=1 (seg and linear) and R=2: a batch
  on a group's first substep, on its second and in the tail group, two
  emitters in one group, a quota that stops mid-run and a pool that runs
  full, with ``num_active`` and ``emitted`` equal to the host's count of
  the cadence; one key per fire pattern, not per start row; a fresh
  ``EmitterState`` replays its own seeds;
- ``ShardedWCSPHRect`` on 2x2 and 2x2x2 meshes of CPU devices,
  ``rollout`` and ``rollout_coupled``; flags that accumulate over two
  groups and a reset in place; a rebalance and a regrow each a new key,
  and ``run``'s steering through the runner; a graph ``rollout`` after an
  eager ``rollout_emit``;
- both paths through the runner against ``tisph_tpu`` at the tolerances
  of ``tests/test_torch_emitter.py`` and ``tests/test_torch_parallel2d.py``.

Marked ``cuda`` (skipped here): real capture of both paths against
``graphs=False``, bitwise.
"""

import dataclasses

import jax
import pytest
import torch

import tisph_tpu as tt
from tisph_tpu.geometry import emitter as jem
from tisph_tpu.ops.neighbors import SweepConfig
from tisph_tpu.parallel import ShardedWCSPH2D as JShardedWCSPH2D
from tisph_tpu.parallel import make_mesh2d as jax_mesh2d

import tisph_tpu_torch as pt
from tisph_tpu_torch.geometry import emitter as pem
from tisph_tpu_torch.models.graphs import GroupRunner
from tisph_tpu_torch.parallel import ShardedWCSPHRect, make_mesh2d, make_mesh3d

import test_torch_emitter as temit
import test_torch_parallel2d as trect
from test_torch_graphs import _direct, _equal

torch.set_num_threads(2)


def _emit_scene(emitters, extra=128, device="cpu"):
    """tests/test_aux.py's 2D emitter scene with the given emitters:
    (start, end, interval, max_particles) each."""
    raw = temit._scene()
    raw["emitters"] = [
        {"start": list(a), "end": list(b), "velocity": [0.0, -1.0], "interval": i,
         "maxParticles": m} for a, b, i, m in emitters]
    scene = pt.scene_from_dict(raw)
    state = pt.build_state(scene, device=device, extra_capacity=extra)
    return scene, state, [pem.make_emitter_state(em, scene, device) for em in scene.emitters]


def _cadence(ems, num_active, capacity, steps):
    """(num_active, emitted per emitter) after ``steps`` solver steps,
    counted from the emitters' parameters in their order."""
    emitted = [es.emitted for es in ems]
    for step in range(steps):
        for e, es in enumerate(ems):
            b = es.batch_size
            if ((es.step + step) % es.interval == 0 and num_active + b <= capacity
                    and (es.max_particles <= 0 or emitted[e] + b <= es.max_particles)):
                num_active, emitted[e] = num_active + b, emitted[e] + b
    return num_active, emitted


_HIGH = ((1.0, 1.5), (1.08, 1.5001))
_LEFT = ((0.2, 1.5), (0.28, 1.5001))

# (R, layout, steps, emitters, extra capacity): the groups at R=2 and 7
# steps are (0, 1), (2, 3), (4, 5), (6): interval 3 fires on a first
# substep, a second and the tail
_EMIT_CASES = {
    "R=1": (1, "seg", 7, [(*_HIGH, 3, 0)], 128),
    "R=1 linear": (1, "linear", 7, [(*_HIGH, 3, 0)], 128),
    "R=2 first, second and tail": (2, "seg", 7, [(*_HIGH, 3, 0)], 128),
    "R=2 two emitters in one group": (2, "seg", 8, [(*_HIGH, 2, 0), (*_LEFT, 4, 0)], 128),
    "R=2 quota stops mid-run": (2, "seg", 12, [(*_HIGH, 3, 10)], 128),
    "R=2 pool runs full": (2, "seg", 12, [(*_HIGH, 2, 0)], 12),
}


@pytest.mark.parametrize("case", list(_EMIT_CASES))
def test_emit_plumbing_equals_eager(case):
    """``advance`` (``rollout_emit``) through the runner against the eager
    loop: every field and emitter counter bitwise, and the host's count of
    the cadence."""
    R, layout, steps, emitters, extra = _EMIT_CASES[case]
    scene, state, ems = _emit_scene(emitters, extra)
    solver = pt.WCSPH(scene, device="cpu", resort_every=R, layout=layout)
    state = solver.bind(state)
    want, _, want_ems = pt.advance(solver, state, None, steps, ems)
    runner = _direct(solver)
    got, _, got_ems = pt.advance(solver, state, None, steps, ems)
    assert runner._base is not None
    _equal(got, want)
    for g, w in zip(got_ems, want_ems):
        _equal(g, w)
        assert g.seeds_x is w.seeds_x  # the caller's tensors, not the buffers
    n, emitted = _cadence(ems, state.num_active, state.capacity, steps)
    assert got.num_active == n and [es.emitted for es in got_ems] == emitted
    assert all(es.step == steps for es in got_ems)
    b = ems[0].batch_size
    if "quota" in case:
        assert emitted == [2 * b] and 2 * b <= 10 < 3 * b
    if "full" in case:
        assert got.num_active + b > got.capacity and emitted[0] < 6 * b
    if "two" in case:
        both = (True, True)
        assert any(p is not None and both in p[1] for _, p in runner._graphs), runner._graphs
    if "tail" in case:
        assert (1, (False, ((True,),))) in runner._graphs
        assert any(p is not None and p[1] == ((False,), (True,)) for _, p in runner._graphs)


def test_emit_keys_follow_fire_patterns():
    """At R=2 with one emitter every 3 steps the groups take three
    patterns (none, the first substep, the second): three keys however many
    batches fire, and one start-row buffer per slot."""
    scene, state, ems = _emit_scene([(*_HIGH, 3, 0)], extra=512)
    solver = pt.WCSPH(scene, device="cpu", resort_every=2)
    state = solver.bind(state)
    runner = _direct(solver)
    st, es1 = solver.rollout_emit(state, ems, 12)
    keys = set(runner._graphs)
    assert keys == {(2, None), (2, (False, ((True,), (False,)))),
                    (2, (False, ((False,), (True,))))}
    st, es2 = solver.rollout_emit(st, es1, 24)
    assert set(runner._graphs) == keys and len(runner._starts) == 2
    assert es2[0].emitted == 12 * ems[0].batch_size  # 12 batches, 3 keys


def test_fresh_emitter_state_replays_its_own_seeds():
    """The seeds are copied into the runner's buffers at every call: a
    second call with other seeds tensors (as ``load_npz`` or
    ``make_emitter_state`` give) emits those."""
    scene, state, ems = _emit_scene([(*_HIGH, 3, 0)])
    moved = [dataclasses.replace(ems[0], seeds_x=ems[0].seeds_x - 0.3,
                                 velocity=ems[0].velocity * 2)]
    solver = pt.WCSPH(scene, device="cpu", resort_every=2)
    state = solver.bind(state)
    want = solver.rollout_emit(state, moved, 4)
    _direct(solver)
    solver.rollout_emit(state, ems, 4)
    got = solver.rollout_emit(state, moved, 4)
    _equal(got[0], want[0])
    _equal(got[1][0], want[1][0])


@pytest.mark.parametrize("resort", [1, 2])
def test_emit_through_runner_matches_jax(resort):
    """tests/test_torch_emitter.py's rollout_emit parity, through the
    runner: R=1 against tisph_tpu's blocked sweeps (20 steps), R=2 against
    its seg rollout_emit in interpret mode (10 steps), x atol 1e-5."""
    raw = temit._scene(interval=7, max_particles=40)
    steps = 20 if resort == 1 else 10
    scene, jsolver, js, ps0 = temit._start(raw, resort=resort)
    jes = jem.make_emitter_state(scene.emitters[0], scene)
    want, (jes_w,) = jsolver.rollout_emit(js, [jes], steps)
    port = pt.WCSPH(pt.scene_from_dict(raw), device="cpu", resort_every=resort)
    ps0 = port.bind(ps0)
    runner = _direct(port)
    pes = pem.make_emitter_state(port.scene.emitters[0], port.scene, "cpu")
    got, (pes,) = port.rollout_emit(ps0, [pes], steps)
    assert runner._base is not None and pes.emitted > 0
    temit._check_emitter(pes, jes_w)
    temit._check_states(got, want)


# -- the rectangle ------------------------------------------------------------------

def _rect(shape, raw=None, **kw):
    scene, start = trect._start(raw or trect._raw())
    solver = ShardedWCSPHRect(scene, trect._mesh(shape), **kw)
    return solver, solver.bind(start)


def _same_shards(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_rect_plumbing_equals_eager(shape):
    """``rollout`` through the runner, 5 steps at R=2 (two groups and the
    tail), against the eager loop: every shard's fields, its live rows,
    the live-row counts and the flags bitwise."""
    eager, shards = _rect(shape, resort_every=2)
    want = eager.rollout(shards, 5)
    solver, shards = _rect(shape, resort_every=2)
    runner = _direct(solver)
    counts, flags = solver._counts, solver._flags
    got = solver.rollout(shards, 5)
    assert set(runner._graphs) == {(2, None), (1, None)}
    _same_shards(got, want)
    assert solver._counts is counts and solver._flags is flags  # written in place
    assert torch.equal(solver._counts, eager._counts)
    assert torch.equal(solver._flags, eager._flags)


def test_rect_coupled_plumbing_equals_eager(tmp_path):
    """``rollout_coupled`` on 2x2 through the runner, 3 steps at R=2: the
    shards and the bodies bitwise the eager loop's."""
    scene = trect._rigid_scene(tmp_path)
    start = trect._tagged(pt.build_state(scene, device="cpu"))
    out = []
    for direct in (False, True):
        solver = ShardedWCSPHRect(scene, trect._mesh((2, 2)), resort_every=2)
        shards = solver.bind(start)
        rigid = solver.init_rigid(shards)
        if direct:
            runner = _direct(solver)
        out.append(solver.rollout_coupled(shards, rigid, 3))
    assert runner._base is not None
    _same_shards(out[1][0], out[0][0])
    _equal(out[1][1], out[0][1])


def test_rect_flags_accumulate_and_reset_in_place():
    """Rows teleported past a migration cap of 128 trip the migration flag
    at each of the next two builds: through the runner the flags add up
    over two groups as on the eager loop, ``reset_flags`` zeroes them in
    place, and the next group counts from 0."""
    runs = []
    for direct in (False, True):
        solver, shards = _rect((2, 4))
        solver.cap_m[1] = 128
        shards = trect._teleport(shards, 1, min(300, shards[1].num_active), 1, 0.55)
        if direct:
            _direct(solver)
        flags = solver._flags
        shards = solver.rollout(shards, 2)
        after_two = solver._flags.clone()
        solver.reset_flags()
        assert solver._flags is flags and int(flags.abs().sum()) == 0
        shards = solver.rollout(shards, 1)
        runs.append((shards, after_two, solver._flags.clone()))
    (want, w2, w1), (got, g2, g1) = runs
    assert int(w2[2]) == 2 and int(w1[0]) > 0  # a trip at each build; recounted
    assert torch.equal(g2, w2) and torch.equal(g1, w1)
    _same_shards(got, want)


def test_rect_rebalance_and_regrow_give_new_keys():
    """What ``run``'s steering changes is in the key: a regrow of either
    cap and a rebalance each give a new one, so no stale graph replays."""
    solver, shards = _rect((2, 2))
    runner = GroupRunner(solver, capture=False)
    sub = solver._substep
    key = runner.key((shards,), 2, sub)
    assert runner.key((shards,), 2, sub) == key
    keys = {key}
    for kind in ("h", "m"):
        solver.regrow_buffers(kinds=(kind,))
        keys.add(runner.key((shards,), 2, sub))
    shards = solver.rebalance(shards)
    keys.add(runner.key((shards,), 2, sub))
    assert len(keys) == 4


@pytest.mark.parametrize("steer", ["rebalance", "halo regrow"])
def test_rect_run_steering_through_runner(steer):
    """``run`` through the runner, bitwise the eager ``run``: a tiny warn
    fraction makes it rebalance (tests/test_torch_parallel2d.py's drift
    case), halo caps of 128 make it regrow them; each steering step is a
    new key."""
    out = []
    for direct in (False, True):
        solver, shards = _rect((2, 2), balance_slack=1.2)
        if steer == "halo regrow":
            solver.cap_h = [128, 128]
        calls = []
        rebalance = solver.rebalance
        solver.rebalance = lambda sh: calls.append(1) or rebalance(sh)
        if direct:
            runner = _direct(solver)
            base0 = runner.key((shards,), 0, solver._substep)[:-2]
        frac = 0.05 if steer == "rebalance" else 0.9
        got = solver.run(shards, 8, check_every=4 if steer == "rebalance" else 1,
                         warn_frac=frac)
        out.append((got, solver.cap_h, solver._cuts_made, len(calls)))
    (want, caps_w, cuts_w, n_w), (got, caps_g, cuts_g, n_g) = out
    _same_shards(got, want)
    assert (caps_g, cuts_g, n_g) == (caps_w, cuts_w, n_w)
    if steer == "rebalance":
        assert n_g >= 1
    else:
        assert min(caps_g) > 128
    assert runner._base != base0  # the steering gave a new key


def test_rect_graph_rollout_after_eager_emit():
    """The rectangle's ``rollout_emit`` (the eager loop, and through the
    runner) grows the device live-row counts in place by the batch emitted
    after the last rebuild; a graph ``rollout`` after it gives each shard
    the live rows the eager path gives."""
    out = []
    for direct in (False, True):
        scene, start = trect._start(trect._emit_raw(), extra_capacity=512)
        solver = ShardedWCSPHRect(scene, trect._mesh((2, 2)), resort_every=2)
        shards = solver.bind(start)
        if direct:
            runner = _direct(solver)
        es = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
        # emissions at steps 0 and 5: the second after the last rebuild
        shards, ems = solver.rollout_emit(shards, [es], 6)
        assert ems[0].emitted == 2 * es.batch_size
        assert int(solver._counts.sum()) == sum(st.num_active for st in shards) \
            == start.num_active + 2 * es.batch_size
        out.append((solver.rollout(shards, 3), ems[0]))
    assert runner._base is not None and (2, None) in runner._graphs
    (want, w_es), (got, g_es) = out
    _equal(g_es, w_es)
    assert [st.num_active for st in got] == [st.num_active for st in want]
    _same_shards(got, want)


def test_rect_through_runner_matches_jax_rect():
    """tests/test_torch_parallel2d.py's parity with tisph_tpu's
    ShardedWCSPH2D on a 2x2 mesh of the virtual CPU devices (its seg
    kernel in interpret mode), through the runner, 5 steps at R=1."""
    raw = trect._raw()
    jscene, jstate = trect._jax_tagged(raw)
    js = JShardedWCSPH2D(jscene, jax_mesh2d(2, 2), sweep_cfg=SweepConfig(**trect._JCFG))
    jst = js.bind(jstate)
    for _ in range(5):
        jst = js.step(jst)
    want = trect._jax_live(jax.device_get(jst))
    solver, shards = _rect((2, 2))
    runner = _direct(solver)
    shards = solver.rollout(shards, 5)
    assert set(runner._graphs) == {(1, None)}
    trect._close(solver.gather_state(shards), want)


# -- on the card -----------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_EMIT_CASES))
def test_emit_replay_equals_eager_on_cuda(case):
    """Real capture: ``rollout_emit`` on the card is a graph replay per
    group, bitwise ``graphs=False``, with at most one capture per key."""
    _need_cuda()
    R, layout, steps, emitters, extra = _EMIT_CASES[case]
    scene, state, ems = _emit_scene(emitters, extra, device="cuda")
    out = []
    for graphs in (False, None):
        solver = pt.WCSPH(scene, device="cuda", resort_every=R, layout=layout, graphs=graphs)
        out.append(solver.rollout_emit(solver.bind(state), ems, steps))
    assert solver.graphs and solver._runner.captures == len(solver._runner._graphs)
    _equal(out[1][0], out[0][0])
    for g, w in zip(out[1][1], out[0][1]):
        _equal(g, w)


@pytest.mark.cuda
def test_rect_replay_equals_eager_on_cuda(tmp_path):
    """Real capture: 2x2 and 2x2x2 on one card (``rollout``, 5 steps at
    R=2) and the coupled 2x2 (3 steps), bitwise ``graphs=False``."""
    _need_cuda()
    scene = pt.scene_from_dict(trect._raw())
    start = pt.build_state(scene, device="cuda")
    for shape in ((2, 2), (2, 2, 2)):
        make = make_mesh2d if len(shape) == 2 else make_mesh3d
        out = []
        for graphs in (False, None):
            solver = ShardedWCSPHRect(scene, make(*shape, devices=["cuda:0"] * (2 ** len(shape))),
                                      resort_every=2, graphs=graphs)
            out.append((solver.rollout(solver.bind(start), 5), solver._flags.clone()))
        assert solver.graphs and solver._runner.captures == 2
        _same_shards(out[1][0], out[0][0])
        assert torch.equal(out[1][1], out[0][1])
    r_scene = trect._rigid_scene(tmp_path)
    r_start = pt.build_state(r_scene, device="cuda")
    out = []
    for graphs in (False, None):
        solver = ShardedWCSPHRect(r_scene, make_mesh2d(2, 2, devices=["cuda:0"] * 4),
                                  resort_every=2, graphs=graphs)
        shards = solver.bind(r_start)
        out.append(solver.rollout_coupled(shards, solver.init_rigid(shards), 3))
    _same_shards(out[1][0], out[0][0])
    _equal(out[1][1], out[0][1])
