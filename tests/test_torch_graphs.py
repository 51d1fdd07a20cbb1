"""The R-group as one CUDA graph replay (``tisph_tpu_torch.models.graphs``).

On the CPU (the eager loop; no capture without a card):

- ``graphs=True`` raises on a CPU solver and on a class that keeps the
  eager loop (a slab or rectangle over several devices); None is on for a
  CUDA ``WCSPH``, ``WCSPHRigid`` and ``WCSPHLegacy`` and a slab or
  rectangle on one card, off elsewhere; ``rollout_emit`` takes the
  graph path wherever the groups do (``tests/test_torch_graphs_emit_rect.py``
  and ``tests/test_torch_graphs_slab.py`` hold it and the decompositions'
  plumbing);
- the runner's plumbing (copy in, group on the static buffers, write back,
  tail group, copy out), with a direct call of the group in place of each
  replay, equals the eager ``_groups`` bitwise: ``WCSPH`` at R=2 over 1, 2,
  3 and 5 steps on the 3D golden scene (4,495 particles), and
  ``WCSPHRigid``'s coupled carry; every entry point goes through it;
- that rollout holds against ``tisph_tpu``'s rollout at
  ``tests/test_golden.py``'s tolerances;
- a returned state owns its memory: a later rollout leaves it unchanged;
- a change of capacity or of k is a new capture key.

Marked ``cuda`` (skipped here): the same bitwise checks with real capture,
and a capture that meets a host read raises, naming where.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import state_to_host as jax_to_host

import tisph_tpu_torch as pt
from tisph_tpu_torch.geometry.emitter import make_emitter_state
from tisph_tpu_torch.models.graphs import GroupRunner
from tisph_tpu_torch.models.state import pad_state_capacity
from tisph_tpu_torch.ops.grid import state_fields

from test_golden import CASES
from test_torch_solver import SCENE, _body_scene

torch.set_num_threads(2)

GOLDEN_3D = CASES["3d_dam_break"][0]


def _equal(a, b):
    """Every tensor field bitwise equal, and the host fields equal."""
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def _golden(resort=2, device="cpu"):
    scene = pt.scene_from_dict(GOLDEN_3D)
    solver = pt.WCSPH(scene, device=device, resort_every=resort)
    return solver, solver.bind(pt.build_state(scene, device=device))


def _rigid(tmp_path, device="cpu"):
    raw = _body_scene(tmp_path, dynamic=True)
    scene = pt.scene_from_dict(raw, base_dir=str(tmp_path))
    return pt.make_solver(scene, pt.build_state(scene, device=device), device=device,
                          resort_every=2)


def _direct(solver):
    """Route the solver's groups through a runner that calls each group
    where it would replay it: the graph path's plumbing on the CPU."""
    solver.graphs = True
    solver._runner = GroupRunner(solver, capture=False)
    return solver._runner


# -- choosing the path ---------------------------------------------------------

def test_graphs_default_and_refusals(tmp_path):
    """None is on for a CUDA WCSPH, WCSPHRigid and WCSPHLegacy (whose
    pair sums no longer read the host); ``rollout_emit`` with
    graphs=True no longer refuses: it takes the graph path, so a CPU state
    reaches the device check."""
    scene = pt.scene_from_dict(SCENE)
    assert pt.WCSPH(scene, device="cuda").graphs
    assert not pt.WCSPH(scene, device="cuda", graphs=False).graphs
    assert not pt.WCSPH(scene, device="cpu").graphs
    body = pt.scene_from_dict(_body_scene(tmp_path, dynamic=True), base_dir=str(tmp_path))
    assert pt.WCSPHRigid(body, device="cuda").graphs
    assert pt.WCSPHLegacy(scene, device="cuda").graphs
    with pytest.raises(ValueError, match="needs a CUDA device"):
        pt.WCSPH(scene, device="cpu", graphs=True)
    assert pt.WCSPHLegacy(scene, device="cuda", graphs=True).graphs
    solver = pt.WCSPH(scene, device="cuda", resort_every=2, graphs=True)
    raw = dict(SCENE, emitters=[{"start": [0.6, 0.8, 0.4], "end": [0.7, 0.8001, 0.5],
                                 "velocity": [0.0, -1.0, 0.0], "interval": 3,
                                 "maxParticles": 20}])
    em_scene = pt.scene_from_dict(raw)
    state = pt.build_state(em_scene, device="cpu")
    ems = [make_emitter_state(em_scene.emitters[0], em_scene, "cpu")]
    assert not hasattr(pt.WCSPH, "emit_eager_loop")
    with pytest.raises(ValueError, match="state is on cpu, solver on cuda"):
        solver.rollout_emit(state, ems, 2)


def test_sharded_solvers_keep_the_eager_loop():
    """What keeps the eager loop, with its reason, and refuses graphs=True:
    a slab or a rectangle over several devices; the legacy solver no
    longer does.  On one card the slab and the
    rectangle replay their groups, ``rollout_emit`` too (no class keeps an
    eager loop for emission); on the CPU they run the eager loop."""
    from tisph_tpu_torch.models.solver_base import SolverBase
    from tisph_tpu_torch.parallel import (
        ShardedWCSPH,
        ShardedWCSPHRect,
        make_mesh,
        make_mesh2d,
    )

    scene = pt.scene_from_dict(SCENE)
    assert pt.WCSPH.eager_loop is None and pt.WCSPHRigid.eager_loop is None
    assert pt.WCSPHLegacy.eager_loop is None
    assert not hasattr(SolverBase, "emit_eager_loop")
    one = ["cuda:0"] * 4
    several = ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    for cls, make in ((ShardedWCSPH, lambda d: make_mesh(devices=d)),
                      (ShardedWCSPHRect, lambda d: make_mesh2d(2, 2, devices=d))):
        assert cls.eager_loop is None
        solver = cls(scene, make(one))
        assert solver.graphs and solver.eager_loop is None
        assert cls(scene, make(one), graphs=True).graphs
        assert not cls(scene, make(one), graphs=False).graphs
        assert not cls(scene, make(["cpu"] * 4)).graphs
        multi = cls(scene, make(several))
        assert not multi.graphs and "several devices" in multi.eager_loop
        with pytest.raises(ValueError, match=f"{cls.__name__} runs the eager loop"):
            cls(scene, make(several), graphs=True)


# -- the plumbing, bitwise against the eager groups ---------------------------

@pytest.mark.parametrize("steps", [1, 2, 3, 5])
def test_plumbing_equals_eager_groups(steps):
    """Groups [1], [2], [2, 1], [2, 2, 1]: the tail group, the buffer
    write-back and the copy-out, bitwise the eager loop's."""
    solver, state = _golden()
    want = solver.rollout(state, steps)
    runner = GroupRunner(solver, capture=False)
    got = runner.rollout((state,), steps, 2, solver._substep)[0]
    _equal(got, want)
    assert not torch.equal(got.x, state.x)


def test_coupled_plumbing_equals_eager_groups(tmp_path):
    solver, state, rigid = _rigid(tmp_path)
    want = solver.rollout_coupled(state, rigid, 3)
    runner = GroupRunner(solver, capture=False)
    got = runner.rollout((state, rigid), 3, 2, solver._coupled_substep)
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    assert not torch.equal(got[1].com, rigid.com)


def test_every_entry_point_goes_through_the_runner(tmp_path):
    """step, rollout and run; step_coupled, rollout_coupled and
    run_coupled: each through the runner, each bitwise the eager loop."""
    solver, state = _golden()
    eager = (solver.step(state), solver.rollout(state, 3), solver.run(state, 3, check_every=2))
    runner = _direct(solver)
    got = (solver.step(state), solver.rollout(state, 3), solver.run(state, 3, check_every=2))
    assert runner._base is not None
    for a, b in zip(got, eager):
        _equal(a, b)

    solver, state, rigid = _rigid(tmp_path)
    eager = (solver.step_coupled(state, rigid), solver.rollout_coupled(state, rigid, 3),
             solver.run_coupled(state, rigid, 3, check_every=2))
    runner = _direct(solver)
    got = (solver.step_coupled(state, rigid), solver.rollout_coupled(state, rigid, 3),
           solver.run_coupled(state, rigid, 3, check_every=2))
    assert runner._base is not None
    for a, b in zip(got, eager):
        _equal(a[0], b[0])
        _equal(a[1], b[1])


def test_runner_rollout_matches_jax():
    """The runner's R=1 rollout of the 3D golden scene against tisph_tpu's
    (its CPU solver, which runs R=1), 5 steps, by particle, at
    tests/test_golden.py's tolerances."""
    scene = tt.scene_from_dict(GOLDEN_3D)
    jsolver = tt.WCSPH(scene)
    jstate = jsolver.bind(tt.build_state(scene))
    jstate = dataclasses.replace(jstate, object_id=jnp.arange(jstate.capacity, dtype=jnp.int32))
    start = jax_to_host(jstate)
    ref = jax_to_host(jsolver.rollout(jstate, 5))

    solver = pt.WCSPH(pt.scene_from_dict(GOLDEN_3D), device="cpu")
    runner = _direct(solver)
    got = pt.state_to_host(solver.rollout(solver.bind(pt.state_from_host(start, "cpu")), 5))
    assert runner._base is not None
    go, ro = np.argsort(got["object_id"]), np.argsort(np.asarray(ref["object_id"]))
    np.testing.assert_array_equal(got["material"][go], np.asarray(ref["material"])[ro])
    np.testing.assert_allclose(got["x"][go], np.asarray(ref["x"])[ro], atol=5e-5)
    np.testing.assert_allclose(got["v"][go], np.asarray(ref["v"])[ro], atol=5e-2)
    np.testing.assert_allclose(got["density"][go], np.asarray(ref["density"])[ro], rtol=5e-4)
    assert np.abs(got["x"][go] - start["x"][np.argsort(start["object_id"])]).max() > 1e-3


# -- ownership and keys --------------------------------------------------------

def test_returned_state_owns_its_memory(tmp_path):
    solver, state = _golden()
    _direct(solver)
    first = solver.rollout(state, 2)
    kept = {n: getattr(first, n).clone() for n in state_fields(first)}
    second = solver.rollout(first, 3)
    bufs = {b.data_ptr() for b in solver._runner._bufs[0].values()}
    for n in state_fields(first):
        assert torch.equal(getattr(first, n), kept[n]), n
        assert getattr(first, n).data_ptr() not in bufs, n
    assert not torch.equal(second.x, first.x)

    solver, state, rigid = _rigid(tmp_path)
    _direct(solver)
    st, rg = solver.rollout_coupled(state, rigid, 2)
    kept = rg.com.clone(), rg.omega.clone(), st.x.clone()
    solver.rollout_coupled(st, rg, 2)
    assert torch.equal(rg.com, kept[0]) and torch.equal(rg.omega, kept[1])
    assert torch.equal(st.x, kept[2])


def test_capacity_or_k_change_gives_a_new_key():
    solver, state = _golden()
    runner = GroupRunner(solver, capture=False)
    sub = solver._substep
    key = runner.key((state,), 2, sub)
    assert runner.key((state,), 2, sub) == key
    assert runner.key((state,), 1, sub) != key
    padded = pad_state_capacity(state, state.capacity + 8)
    assert runner.key((padded,), 2, sub) != key
    solver.fast_math = False
    assert runner.key((state,), 2, sub) != key
    solver.fast_math = True
    # a new capacity reallocates the buffers: the runner follows it
    runner.rollout((state,), 2, 2, sub)
    got = runner.rollout((padded,), 3, 2, sub)[0]
    assert got.capacity == padded.capacity
    _equal(got, solver.rollout(padded, 3))


# -- on the card -----------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3, 5])
def test_replay_equals_eager_on_cuda(steps):
    """Real capture: the graph rollout of the 3D golden scene at R=2
    equals graphs=False bitwise; the warm-up never advances the state."""
    _need_cuda()
    solver, state = _golden(device="cuda")
    eager = pt.WCSPH(solver.scene, device="cuda", resort_every=2, graphs=False)
    want = eager.rollout(eager.bind(pt.build_state(solver.scene, device="cuda")), steps)
    got = solver.rollout(state, steps)
    assert solver.graphs and solver._runner.captures == (1 if steps < 3 else 2)
    _equal(got, want)
    _equal(solver.rollout(state, steps), want)  # replays only
    assert solver._runner.captures == (1 if steps < 3 else 2)


@pytest.mark.cuda
def test_coupled_replay_equals_eager_on_cuda(tmp_path):
    _need_cuda()
    solver, state, rigid = _rigid(tmp_path, device="cuda")
    eager = pt.WCSPHRigid(solver.scene, device="cuda", resort_every=2, graphs=False)
    want = eager.rollout_coupled(eager.bind(pt.build_state(solver.scene, device="cuda")),
                                 rigid, 5)
    got = solver.rollout_coupled(state, rigid, 5)
    _equal(got[0], want[0])
    _equal(got[1], want[1])


@pytest.mark.cuda
def test_capture_that_reads_the_host_raises_on_cuda():
    _need_cuda()

    class HostRead(pt.WCSPH):
        def _apply(self, state, cache, with_reactions=False):
            if float(state.x.sum()) > 0:  # a host read inside the group
                pass
            return super()._apply(state, cache, with_reactions)

    scene = pt.scene_from_dict(GOLDEN_3D)
    solver = HostRead(scene, device="cuda", resort_every=2, graphs=True)
    state = solver.bind(pt.build_state(scene, device="cuda"))
    with pytest.raises(RuntimeError, match="substep 1 of 2 broke the capture"):
        solver.rollout(state, 2)
