"""The long-run entry points of the port on the CPU: ``run`` on WCSPH,
WCSPHLegacy and the sharded solvers, ``run_coupled`` on WCSPHRigid,
ShardedWCSPH and ShardedWCSPHRect, all through ``SolverBase._run_chunks``.

- ``run`` is ``rollout`` chunk by chunk, bitwise: at R=2 with
  ``check_every=4`` one ``rollout(12)``, with ``check_every=3`` three
  ``rollout(3)`` calls (a chunk that ends inside an R-group makes the next
  one start with a rebuild, as in tisph_tpu);
- against tisph_tpu's ``run`` (seg sweeps in interpret mode, R=2, caps
  large enough that it never regrows them) by object_id at x atol 1e-5,
  and its ``run_coupled`` at tests/test_torch_solver.py's coupled
  tolerances (com atol 1e-5, v_com and omega 1e-4);
- the sharded ``run_coupled`` on 2 slab and 2x2 shards against the
  single-device one at tests/test_torch_parallel*.py's tolerances;
- an argument that steers a cap the port has not raises a TypeError.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.models.wcsph_rigid import WCSPHRigid as JWCSPHRigid
from tisph_tpu.ops.neighbors import SweepConfig

import tisph_tpu_torch as pt
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.parallel import ShardedWCSPH, ShardedWCSPHRect, make_mesh, make_mesh2d

from test_torch_solver import SCENE, _body_scene, _by_id, _by_tag, _tagged

torch.set_num_threads(2)


def _solver_and_state(resort=2, cls=None):
    scene = pt.scene_from_dict(SCENE)
    solver = (cls or pt.WCSPH)(scene, device="cpu", resort_every=resort)
    return solver, solver.bind(pt.build_state(scene, device="cpu"))


def _equal(a, b):
    for f in gridops.state_fields(a):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.num_active == b.num_active


@pytest.mark.parametrize("check_every,calls", [(4, [12]), (3, [3, 3, 3])])
def test_run_is_rollout_chunk_by_chunk(check_every, calls):
    solver, state = _solver_and_state()
    want = state
    for k in calls:
        want = solver.rollout(want, k)
    _equal(solver.run(state, sum(calls), check_every=check_every), want)


def test_run_splits_a_group_at_a_chunk_end():
    """check_every=3 at R=2 rebuilds after step 3, which rollout(6) does
    not: the two trajectories part (the rebuild is not 'fixed')."""
    solver, state = _solver_and_state()
    split = solver.run(state, 6, check_every=3)
    whole = solver.rollout(state, 6)
    assert not torch.equal(split.x, whole.x)


def test_legacy_run_is_rollout():
    solver, state = _solver_and_state(resort=1, cls=pt.WCSPHLegacy)
    _equal(solver.run(state, 5, check_every=2), solver.rollout(state, 5))


def test_run_verbose_prints_a_rate_per_chunk(capsys):
    solver, state = _solver_and_state()
    solver.run(state, 5, check_every=2, verbose=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "particle-steps/s" in ln]
    assert [ln.split(":")[0] for ln in lines] == ["[tisph] steps 0-2", "[tisph] steps 2-4",
                                                   "[tisph] steps 4-5"]


def test_run_matches_jax_run():
    """tisph_tpu's WCSPH.run on its seg sweeps (interpret mode, R=2) with a
    window and row-pad cap that two chunks neither regrow nor shrink."""
    scene = tt.scene_from_dict(SCENE)
    solver = tt.WCSPH(scene, sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
        layout="seg", pad_capacity=8192, resort_every=2))
    state = solver.bind(jax_pad(tt.build_state(scene), 2048))
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    start = jax_to_host(state)
    cfg0 = solver.sweep_cfg
    want = _by_id(jax_to_host(solver.run(state, 6, check_every=3)))
    assert solver.sweep_cfg == cfg0  # never regrown

    port = pt.WCSPH(pt.scene_from_dict(SCENE), device="cpu", resort_every=2)
    got = _by_id(pt.state_to_host(port.run(pt.state_from_host(start, "cpu"), 6,
                                           check_every=3)))
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_array_equal(got["material"], want["material"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5)
    assert np.abs(got["x"] - start["x"][np.argsort(start["object_id"])]).max() > 1e-3


def test_run_coupled_matches_jax(tmp_path):
    raw = _body_scene(tmp_path, dynamic=True)
    scene = tt.scene_from_dict(raw, base_dir=str(tmp_path))
    solver = JWCSPHRigid(scene, sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
        layout="seg", pad_capacity=8192, resort_every=2, fast_math=False))
    state = _tagged(solver.bind(tt.build_state(scene)))
    rigid = solver.init_rigid(state)
    start = jax_to_host(state)
    rstart = {f.name: np.asarray(getattr(rigid, f.name)) for f in dataclasses.fields(rigid)}
    cfg0 = solver.sweep_cfg
    s_j, r_j = solver.run_coupled(state, rigid, 4, check_every=2)
    assert solver.sweep_cfg == cfg0  # never regrown
    want, r_want = _by_tag(jax_to_host(s_j)), jax.device_get(r_j)

    port = pt.WCSPHRigid(pt.scene_from_dict(raw, base_dir=str(tmp_path)), device="cpu",
                         resort_every=2)
    # an unbound state: run_coupled binds it
    st, rg = port.run_coupled(pt.state_from_host(start, "cpu"),
                              pt.rigid_from_host(rstart, "cpu"), 4, check_every=2)
    got = _by_tag(pt.state_to_host(st))
    np.testing.assert_allclose(rg.com.numpy(), r_want.com, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rg.v_com.numpy(), r_want.v_com, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rg.omega.numpy(), r_want.omega, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["material"], want["material"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-4)
    assert float(rg.v_com[0, 1]) != 0.0  # the body moved


def test_run_coupled_is_rollout_coupled(tmp_path):
    raw = _body_scene(tmp_path, dynamic=True, radius=0.04)
    scene = pt.scene_from_dict(raw, base_dir=str(tmp_path))
    solver, state, rigid = pt.make_solver(scene, pt.build_state(scene, device="cpu"),
                                          device="cpu", resort_every=2)
    s1, r1 = solver.run_coupled(state, rigid, 6, check_every=2)
    s2, r2 = solver.rollout_coupled(state, rigid, 6)
    _equal(s1, s2)
    for f in dataclasses.fields(r1):
        assert torch.equal(getattr(r1, f.name), getattr(r2, f.name)), f.name


@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_sharded_run_coupled_matches_single_device(tmp_path, shape):
    """The slab (2 shards) and rectangle (2x2) run_coupled against
    WCSPHRigid.run_coupled: x atol 1e-5, density rtol 1e-4, com atol 1e-6,
    v_com and omega atol 1e-4 (tests/test_torch_parallel.py:377-400)."""
    raw = _body_scene(tmp_path, dynamic=True, radius=0.04)
    scene = pt.scene_from_dict(raw, base_dir=str(tmp_path))
    start = pt.build_state(scene, device="cpu")
    tags = torch.arange(start.capacity, dtype=torch.float32)
    start = dataclasses.replace(start, color=torch.cat([tags[:, None], start.color[:, 1:]], 1))
    single = pt.WCSPHRigid(scene, device="cpu", resort_every=2)
    st1 = single.bind(start)
    rg0 = single.init_rigid(st1)
    st1, rg1 = single.run_coupled(st1, rg0, 4, check_every=2)
    devices = ["cpu"] * int(np.prod(shape))
    if len(shape) == 1:
        solver = ShardedWCSPH(scene, make_mesh(devices=devices), resort_every=2)
    else:
        solver = ShardedWCSPHRect(scene, make_mesh2d(*shape, devices=devices), resort_every=2)
    shards, rg2 = solver.run_coupled(solver.bind(start), rg0, 4, check_every=2)
    got = solver.gather_state(shards)
    n = st1.num_active
    assert got.num_active == n
    g_order = torch.argsort(got.color[:n, 0])
    w_order = torch.argsort(st1.color[:n, 0])
    assert torch.equal(got.color[:n, 0][g_order], st1.color[:n, 0][w_order])
    assert float((got.x[:n][g_order] - st1.x[:n][w_order]).abs().max()) < 1e-5
    torch.testing.assert_close(got.density[:n][g_order], st1.density[:n][w_order],
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(rg2.com, rg1.com, rtol=0, atol=1e-6)
    torch.testing.assert_close(rg2.v_com, rg1.v_com, rtol=0, atol=1e-4)
    torch.testing.assert_close(rg2.omega, rg1.omega, rtol=0, atol=1e-4)
    assert float((rg2.v_com - rg0.v_com).abs().max()) > 0  # the body moved


@pytest.mark.parametrize("cap", [{"max_dispatch": 400}, {"grow": 1.5}, {"warn_frac": 0.9}])
def test_run_refuses_cap_arguments(cap):
    """run steers no window or row-pad cap: tisph_tpu's arguments for them
    raise before a step runs."""
    solver, state = _solver_and_state()
    with pytest.raises(TypeError):
        solver.run(state, 2, **cap)


def test_sharded_run_refuses_cap_arguments(tmp_path):
    scene = pt.scene_from_dict(SCENE)
    slab = ShardedWCSPH(scene, make_mesh(devices=["cpu"] * 2))
    shards = slab.bind(pt.build_state(scene, device="cpu"))
    with pytest.raises(TypeError):
        slab.run(shards, 2, max_dispatch=400)
    raw = _body_scene(tmp_path, dynamic=True, radius=0.04)
    body = pt.scene_from_dict(raw, base_dir=str(tmp_path))
    rect = ShardedWCSPHRect(body, make_mesh2d(2, 2, devices=["cpu"] * 4))
    shards = rect.bind(pt.build_state(body, device="cpu"))
    with pytest.raises(TypeError):
        rect.run_coupled(shards, rect.init_rigid(shards), 2, grow=1.5)


@pytest.mark.parametrize("which", ["wcsph", "slab", "rect", "rigid"])
def test_run_takes_no_positional_argument_after_check_every(which, tmp_path):
    """tisph_tpu's run takes ``grow`` fourth: a call written for it,
    ``run(s, n, 400, 1.5)``, raises a TypeError before a step runs instead
    of turning on ``verbose`` (or, on the rectangle, setting
    ``warn_frac``); the same for run_coupled."""
    scene = pt.scene_from_dict(SCENE)
    if which == "wcsph":
        solver, state = _solver_and_state()
        call = lambda: solver.run(state, 2, 400, 1.5)  # noqa: E731
    elif which == "slab":
        solver = ShardedWCSPH(scene, make_mesh(devices=["cpu"] * 2))
        shards = solver.bind(pt.build_state(scene, device="cpu"))
        call = lambda: solver.run(shards, 2, 400, 1.5)  # noqa: E731
    elif which == "rect":
        solver = ShardedWCSPHRect(scene, make_mesh2d(2, 2, devices=["cpu"] * 4))
        shards = solver.bind(pt.build_state(scene, device="cpu"))
        call = lambda: solver.run(shards, 2, 400, 1.5, False)  # noqa: E731
    else:
        body = pt.scene_from_dict(_body_scene(tmp_path, dynamic=True, radius=0.04),
                                  base_dir=str(tmp_path))
        solver, state, rigid = pt.make_solver(body, pt.build_state(body, device="cpu"),
                                              device="cpu")
        call = lambda: solver.run_coupled(state, rigid, 2, 400, 1.5)  # noqa: E731
    with pytest.raises(TypeError, match="positional"):
        call()
