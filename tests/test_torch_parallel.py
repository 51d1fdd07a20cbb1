"""The port's 1-D sharded solver (tisph_tpu_torch.parallel) on the CPU:
2 to 8 shards on ["cpu"] * n in one process.

- against tisph_tpu's ShardedWCSPH on the 8 virtual devices of
  tests/conftest.py: R=1 on 2 and 4 shards (its default CPU sweeps) and
  R=2 on its seg config with the TPU kernel in interpret mode
  (tests/test_parallel.py:261-275), at tests/test_parallel.py:66-71's
  tolerances (x atol 1e-5, v atol 5e-3, density rtol 1e-4), rows matched
  by a unique object_id;
- against the port's own single-device WCSPH and WCSPHRigid at the same
  tolerances (R=1 and R=2, reference-exact, interior shards whose windows
  are cut on both sides, emitters, the coupled step, per_step volumes);
- the counterparts of tests/test_parallel.py's exchange-resort, halo and
  run() cases;
- kernel A's plain version over a row range, and with an i-row map,
  equals the same rows of the full sweep, in every mode; kernel C's plain
  version over a row range equals the same rows of its full sweep;
- the linear layout (kernel C's path, R=1) on 2 and 4 shards: bitwise the
  single-device linear run, and tisph_tpu's sharded linear layout
  (``SweepConfig(impl="pallas", layout="linear", interpret=True)``) at
  test_parallel.py's tolerances.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops.neighbors import SweepConfig
from tisph_tpu.parallel import ShardedWCSPH as JShardedWCSPH
from tisph_tpu.parallel import make_mesh as jax_mesh

import tisph_tpu_torch as pt
from tisph_tpu_torch.geometry.mesh import box_mesh, save_obj
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.ops import neighbors
from tisph_tpu_torch.parallel import ShardedWCSPH, make_mesh

torch.set_num_threads(2)


def _raw(radius=0.02):
    """tests/test_parallel.py::_scene."""
    return {
        "configuration": {
            "dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
            "particleRadius": radius, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0,
        },
        "fluidBlocks": [{"start": [0.15] * 3, "end": [0.55] * 3,
                         "velocity": [0.2, -1.0, 0.5], "density": 1000.0,
                         "color": [50, 100, 200]}],
    }


def _cpu(n):
    return make_mesh(devices=["cpu"] * n)


def _tagged_start(raw):
    """tisph_tpu's start state with object_id = row, and its host copy."""
    scene = tt.scene_from_dict(raw)
    state = tt.build_state(scene)
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    return scene, state, jax_to_host(state)


def _live_by_id(host):
    live = host["material"] != -1
    order = np.argsort(host["object_id"][live], kind="stable")
    return {k: np.asarray(v)[live][order] for k, v in host.items() if k != "num_active"}


def _close(got, want):
    """tests/test_parallel.py:66-71's tolerances, rows by object_id."""
    g, w = _live_by_id(got), _live_by_id(want)
    np.testing.assert_array_equal(g["object_id"], w["object_id"])
    np.testing.assert_array_equal(g["material"], w["material"])
    assert np.abs(g["x"] - w["x"]).max() < 1e-5
    np.testing.assert_allclose(g["v"], w["v"], atol=5e-3)
    np.testing.assert_allclose(g["density"], w["density"], rtol=1e-4)


def _port_sharded(raw, n, start, steps, **kw):
    solver = ShardedWCSPH(pt.scene_from_dict(raw), _cpu(n), **kw)
    shards = solver.rollout(solver.bind(pt.state_from_host(start, "cpu")), steps)
    return solver, shards


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_jax_sharded(n):
    raw = _raw(0.04)
    scene, state, start = _tagged_start(raw)
    js = JShardedWCSPH(scene, jax_mesh(n))
    jst = js.bind(state)
    for _ in range(5):
        jst = js.step(jst)
    solver, shards = _port_sharded(raw, n, start, 5)
    got = pt.state_to_host(solver.gather_state(shards))
    _close(got, jax_to_host(jax.device_get(jst)))
    assert np.abs(got["x"] - start["x"][:len(got["x"])]).max() > 1e-3  # it moved


def test_sharded_amortized_matches_jax_seg():
    """R=2 against tisph_tpu's sharded seg path (test_parallel.py:261-275)."""
    raw = _raw(0.04)
    scene, state, start = _tagged_start(raw)
    js = JShardedWCSPH(scene, jax_mesh(4), sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=1152, tile=128, interpret=True,
        layout="seg", resort_every=2))
    jst = js.rollout(js.bind(state), 4)
    solver, shards = _port_sharded(raw, 4, start, 4, resort_every=2)
    _close(pt.state_to_host(solver.gather_state(shards)), jax_to_host(jax.device_get(jst)))


@pytest.mark.parametrize("resort_every,compat", [(1, "reference"), (2, "reference"),
                                                 (2, "reference-exact")])
def test_sharded_matches_single_device(resort_every, compat):
    raw = _raw(0.04)
    scene = pt.scene_from_dict(raw)
    single = pt.WCSPH(scene, device="cpu", resort_every=resort_every, compat=compat)
    want = single.rollout(single.bind(pt.build_state(scene, device="cpu")), 6)
    for n in (2, 4):
        solver = ShardedWCSPH(scene, _cpu(n), resort_every=resort_every, compat=compat)
        shards = solver.rollout(solver.bind(pt.build_state(scene, device="cpu")), 6)
        # a halo of one shard's neighbours on 2 shards, the whole array on 4
        assert solver.halo_path == ("neighbours" if n == 2 else "all_gather")
        got = solver.gather_state(shards)
        assert got.num_active == want.num_active
        _close(pt.state_to_host(got), pt.state_to_host(want))


def test_reference_exact_eos_is_the_single_device_one():
    """Under compat="reference-exact" the port's sharded step overwrites
    the fluid density with m W(0) as WCSPH._apply does (and as
    tisph_tpu's single-device WCSPH does, wcsph.py:101-102); tisph_tpu's
    ShardedWCSPH calls tait_pressure directly and skips it, a fault of the
    reference: its sharded density differs from its own single-device
    one, while the port's sharded density equals tisph_tpu's WCSPH."""
    raw = _raw(0.04)
    scene, state, start = _tagged_start(raw)
    j_single = tt.WCSPH(scene, compat="reference-exact")
    want = jax_to_host(j_single.rollout(j_single.bind(state), 3))
    js = JShardedWCSPH(scene, jax_mesh(2), compat="reference-exact")
    jst = js.bind(state)
    for _ in range(3):
        jst = js.step(jst)
    j_sharded = _live_by_id(jax_to_host(jax.device_get(jst)))
    solver, shards = _port_sharded(raw, 2, start, 3, compat="reference-exact")
    got = pt.state_to_host(solver.gather_state(shards))
    _close(got, want)
    fluid = _live_by_id(want)["material"] == 1
    gap = np.abs(j_sharded["density"][fluid] - _live_by_id(want)["density"][fluid]).max()
    assert gap > 1e-2 * float(raw["configuration"]["density0"]), gap


def _slab_raw():
    """A fluid bar long in x: on 4 shards the halo (512 rows) is shorter
    than a shard (640 rows), so an interior shard's window holds rows of
    both neighbours and ends inside the array on each side."""
    raw = _raw(0.04)
    raw["configuration"]["domainEnd"] = [4.0, 0.6, 0.6]
    raw["fluidBlocks"][0].update(start=[0.2, 0.15, 0.15], end=[3.8, 0.35, 0.35],
                                 velocity=[0.5, -1.0, 0.3])
    return raw


@pytest.fixture(scope="module")
def exchange_and_global():
    """6 steps of the bar on 4 shards through each resort, the exchange's
    fallbacks on steps 2 to 6 and the shards' windows, and 6 steps of the
    single-device WCSPH."""
    scene = pt.scene_from_dict(_slab_raw())
    outs, later = {}, {}
    for mode in ("global", "exchange"):
        solver = ShardedWCSPH(scene, _cpu(4), resort=mode)
        shards = solver.step(solver.bind(pt.build_state(scene, device="cpu")))
        solver.occ_resort.zero_()  # the first rebuild may fall back (lattice order)
        for _ in range(5):
            shards = solver.step(shards)
        outs[mode] = solver.gather_state(shards)
        later[mode] = (int(solver.occ_resort), solver.metrics(shards)["resort_fallbacks"],
                       solver.halo_path, [solver._window(s) for s in range(4)],
                       int(solver.occ_halo))
    single = pt.WCSPH(scene, device="cpu")
    outs["single"] = single.rollout(single.bind(pt.build_state(scene, device="cpu")), 6)
    return outs, later


def test_exchange_resort_matches_global_bitwise(exchange_and_global):
    """test_parallel.py:307: 6 steps, every field bitwise equal."""
    outs, later = exchange_and_global
    assert later["exchange"][2] == "neighbours"  # a window is not the whole array
    for f in gridops.state_fields(outs["global"]):
        assert torch.equal(getattr(outs["global"], f), getattr(outs["exchange"], f)), f


def test_interior_shards_match_single_device(exchange_and_global):
    """The two interior shards of 4 sweep windows cut on both sides (the
    halo exchange from each neighbour, not the whole array), and the
    sharded run is the single-device one at test_parallel.py:66-71's
    tolerances."""
    outs, later = exchange_and_global
    windows, cap = later["exchange"][3], outs["exchange"].capacity
    for g0, g1 in windows[1:3]:
        assert 0 < g0 and g1 < cap, windows
    assert later["exchange"][4] == 0  # the halo covered every stencil
    got, want = outs["exchange"], outs["single"]
    assert got.num_active == want.num_active
    _close(pt.state_to_host(got), pt.state_to_host(want))


def test_exchange_resort_rides_edges_in_steady_state(exchange_and_global):
    """test_parallel.py:328: after the first rebuild the exchange path is
    taken on every rebuild (no seam-guard fallback)."""
    _, later = exchange_and_global
    assert later["exchange"][:2] == (0, 0)


def test_exchange_resort_guard_catches_shuffle():
    """test_parallel.py:351: a shuffled state trips the seam guard, counts
    in occ_resort and still gives the global sort's step bitwise."""
    scene = pt.scene_from_dict(_slab_raw())

    def run(mode):
        solver = ShardedWCSPH(scene, _cpu(4), resort=mode, resort_edge=128)
        shards = solver.step(solver.bind(pt.build_state(scene, device="cpu")))
        whole = solver.gather_state(shards)
        perm = torch.from_numpy(np.random.default_rng(7).permutation(whole.capacity))
        whole = dataclasses.replace(whole, **{k: getattr(whole, k)[perm]
                                              for k in gridops.state_fields(whole)})
        solver.occ_resort.zero_()
        return solver, solver.gather_state(solver.step(solver.shard_state(whole)))

    _, out_g = run("global")
    solver_e, out_e = run("exchange")
    assert int(solver_e.occ_resort) >= 1, "seam guard did not trip on a shuffle"
    for f in gridops.state_fields(out_g):
        assert torch.equal(getattr(out_g, f), getattr(out_e, f)), f


def test_exchange_resort_run_deepens_edge():
    """test_parallel.py:386."""
    scene = pt.scene_from_dict(_raw(0.04))
    solver = ShardedWCSPH(scene, _cpu(4), resort_edge=128)
    shards = solver.step(solver.bind(pt.build_state(scene, device="cpu")))
    solver.occ_resort.fill_(10)
    old = solver.resort_edge
    solver.run(shards, 1)
    assert solver.resort_edge > old
    assert int(solver.occ_resort) == 0  # reset after the check


def test_halo_overflow_detected_and_regrown():
    """test_parallel.py:163: fluid driven into the low-x slabs, on 8 shards
    with an undersized halo (128 rows; the reach at bind is about 640): the
    flag trips, run() deepens the halo, and the run stays finite and where
    the single-device run is."""
    raw = {
        "configuration": {
            "dim": 3, "domainStart": [0.0] * 3, "domainEnd": [2.0, 1.0, 1.0],
            "particleRadius": 0.03, "density0": 1000,
            "gravitation": [-6.0, -9.81, 0.0], "c_s": 50.0,
        },
        "fluidBlocks": [{"start": [0.1, 0.55, 0.3], "end": [1.9, 0.75, 0.7],
                         "velocity": [-2.0, -1.0, 0.0], "density": 1000.0,
                         "color": [50, 100, 200]}],
    }
    scene = pt.scene_from_dict(raw)
    solver = ShardedWCSPH(scene, _cpu(8), halo=128)
    shards = solver.rollout(solver.bind(pt.build_state(scene, device="cpu")), 2)
    assert solver.halo_path == "neighbours"
    assert int(solver.occ_halo) == 1, "halo overflow undetected"
    h0 = solver.halo
    shards = solver.run(shards, 3, check_every=3)
    assert solver.halo > h0, "run() did not deepen the halo"
    assert int(solver.occ_halo) == 0  # reset after the checks

    ref = pt.WCSPH(scene, device="cpu")
    want = ref.rollout(ref.bind(pt.build_state(scene, device="cpu")), 8)
    got = solver.gather_state(solver.rollout(shards, 3))
    x1, x2 = want.x[want.fluid_mask].numpy(), got.x[got.fluid_mask].numpy()
    assert np.isfinite(x2).all()
    np.testing.assert_allclose(x1.mean(axis=0), x2.mean(axis=0), atol=0.05)


def test_halo_flag_trips_on_two_shards():
    """On 2 shards a 128-row halo cannot cover the stencils: the port's
    flag trips, where tisph_tpu's stays 0 (its ``_cover_flag`` returns 0
    whenever hops >= n_shards - 1, a fault of the reference); with the
    halo sized at bind the flag stays down and the run equals the
    single-device one."""
    raw = _raw(0.04)
    scene = pt.scene_from_dict(raw)
    solver = ShardedWCSPH(scene, _cpu(2), halo=128)
    shards = solver.rollout(solver.bind(pt.build_state(scene, device="cpu")), 2)
    assert solver.shard_rows > solver.halo  # the window is not the whole array
    assert int(solver.occ_halo) == 1  # 128 rows cannot cover a stencil here
    jscene, jstate, _ = _tagged_start(raw)
    js = JShardedWCSPH(jscene, jax_mesh(2), halo=128)
    jst = js.step(js.bind(jstate))
    assert js.halo == 128 and int(jax.device_get(jst.occ_halo)) == 0
    solver = ShardedWCSPH(scene, _cpu(2))  # the halo sized at bind
    got = solver.gather_state(solver.rollout(solver.bind(
        pt.build_state(scene, device="cpu")), 2))
    assert int(solver.occ_halo) == 0
    single = pt.WCSPH(scene, device="cpu")
    want = single.rollout(single.bind(pt.build_state(scene, device="cpu")), 2)
    _close(pt.state_to_host(got), pt.state_to_host(want))


def _emit_raw():
    """tests/test_parallel.py:113's emitter scene."""
    return {
        "configuration": {
            "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1],
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0, -9.81, 0], "c_s": 50.0,
        },
        "fluidBlocks": [{"start": [0.15, 0.15, 0.15], "end": [0.5, 0.4, 0.5],
                         "velocity": [0, 0, 0], "density": 1000.0, "color": [50, 100, 200]}],
        "emitters": [{"start": [0.5, 0.8, 0.5], "end": [0.62, 0.8001, 0.62],
                      "velocity": [0, -1.0, 0], "interval": 5, "maxParticles": 64}],
    }


@pytest.mark.parametrize("resort_every", [1, 2])
def test_emitter_composes(resort_every):
    """test_parallel.py:113: the 1-D path's emitter pool is the global tail
    (rows land in the last shards with room); against the single-device
    rollout_emit."""
    scene = pt.scene_from_dict(_emit_raw())
    start = pt.build_state(scene, device="cpu", extra_capacity=256)
    single = pt.WCSPH(scene, device="cpu", resort_every=resort_every)
    es = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
    want, ems_w = single.rollout_emit(single.bind(start), [es], 12)
    solver = ShardedWCSPH(scene, _cpu(4), resort_every=resort_every)
    shards, ems = solver.rollout_emit(solver.bind(start), [es], 12)
    assert ems[0].emitted == ems_w[0].emitted == 3 * es.batch_size  # steps 0, 5, 10
    got = solver.gather_state(shards)
    assert got.num_active == want.num_active == start.num_active + ems[0].emitted
    assert [st.num_active for st in shards] == [
        min(max(got.num_active - s * solver.shard_rows, 0), solver.shard_rows)
        for s in range(4)]
    assert int(got.active_mask.sum()) == got.num_active
    _close(pt.state_to_host(got), pt.state_to_host(want))


def _rigid_raw(tmp_path):
    """tests/test_parallel.py::_rigid_scene at radius 0.04."""
    save_obj(box_mesh((0.4, 0.55, 0.4), (0.6, 0.7, 0.6)), tmp_path / "box.obj")
    raw = {
        "configuration": {
            "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1],
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0, -9.81, 0], "c_s": 40.0,
        },
        "rigidBodies": [{"geometryFile": str(tmp_path / "box.obj"), "scale": [1, 1, 1],
                         "translation": [0, 0, 0], "rotationAngle": 0,
                         "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
                         "density": 300.0, "color": [150, 150, 150], "isDynamic": True}],
        "fluidBlocks": [{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.45, 0.9],
                         "velocity": [0, 0, 0], "density": 1000.0,
                         "color": [50, 100, 200]}],
    }
    (tmp_path / "scene.json").write_text(json.dumps(raw))
    return pt.load_scene(str(tmp_path / "scene.json"))


@pytest.mark.parametrize("resort_every", [1, 2])
def test_coupled_matches_single_device(tmp_path, resort_every):
    """test_parallel.py:438: the sharded coupled rollout, each body's sums
    added over the shards, against WCSPHRigid's trajectory and bodies."""
    scene = _rigid_raw(tmp_path)
    steps = 3 if resort_every == 1 else 4
    single = pt.WCSPHRigid(scene, device="cpu", resort_every=resort_every)
    st1 = single.bind(pt.build_state(scene, device="cpu"))
    st1, rg1 = single.rollout_coupled(st1, single.init_rigid(st1), steps)
    solver = ShardedWCSPH(scene, _cpu(4), resort_every=resort_every)
    assert solver.boundary_mode == "per_step"  # chosen for a dynamic scene
    shards = solver.bind(pt.build_state(scene, device="cpu"))
    rg0 = solver.init_rigid(shards)
    torch.testing.assert_close(rg0.com, single.init_rigid(single.bind(
        pt.build_state(scene, device="cpu"))).com, rtol=0, atol=1e-6)
    shards, rg2 = solver.rollout_coupled(shards, rg0, steps)
    got = solver.gather_state(shards)
    n = st1.num_active
    assert got.num_active == n
    assert (got.x[:n] - st1.x[:n]).abs().max() < 1e-5
    torch.testing.assert_close(got.density[:n], st1.density[:n], rtol=1e-4, atol=0)
    torch.testing.assert_close(rg2.com, rg1.com, rtol=0, atol=1e-6)
    torch.testing.assert_close(rg2.v_com, rg1.v_com, rtol=0, atol=1e-4)
    torch.testing.assert_close(rg2.omega, rg1.omega, rtol=0, atol=1e-4)
    assert float((rg2.v_com - rg0.v_com).abs().max()) > 0  # the body moved


def test_plain_step_recomputes_boundary_volumes(tmp_path):
    """test_parallel.py:482: a plain sharded step on a dynamic scene
    recomputes the Akinci volumes every substep (per_step), as the
    single-device per_step step does."""
    scene = _rigid_raw(tmp_path)
    single = pt.WCSPH(scene, device="cpu", boundary_mode="per_step")
    want = single.rollout(single.bind(pt.build_state(scene, device="cpu")), 3)
    solver = ShardedWCSPH(scene, _cpu(4))
    got = solver.gather_state(solver.rollout(
        solver.bind(pt.build_state(scene, device="cpu")), 3))
    bd = got.boundary_mask
    vol0 = float(got.volume[got.fluid_mask].max())
    assert bd.any() and float((got.volume[bd] - vol0).abs().max()) > 0.1 * vol0
    n = want.num_active
    torch.testing.assert_close(got.volume[:n], want.volume[:n], rtol=1e-5, atol=0)
    assert (got.x[:n] - want.x[:n]).abs().max() < 1e-5


@pytest.mark.parametrize("mode", ["density", "bvol", "force", "force_react", "reaction"])
def test_plain_sweep_over_a_row_range(mode):
    """Kernel A's plain version over rows [row0, row0 + n) of an extended
    array equals those rows of the sweep over every row, on a window of
    the sorted array that cuts a cell at each end."""
    raw = _raw(0.04)
    raw["fluidBlocks"][0].update(start=[0.1] * 3, end=[0.6, 0.5, 0.6])
    raw["boundaryBlocks"] = [{"start": [0.6, 0.1, 0.3], "end": [0.72, 0.3, 0.5]}]
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cpu")
    st = solver.bind(pt.build_state(scene, device="cpu"))
    st, ids, _, _ = pt.models.wcsph.cuda_bounds.sort_and_bound(st, solver.spec)
    rng = np.random.default_rng(3)
    st = dataclasses.replace(st, v=torch.from_numpy(
        rng.normal(size=tuple(st.v.shape)).astype(np.float32)))
    # a window starting and ending inside a cell
    cells = ids[:st.num_active]
    g0 = int(torch.nonzero(cells[1:] == cells[:-1])[5]) + 1
    g1 = int(torch.nonzero(cells[1:] == cells[:-1])[-5]) + 1
    assert cells[g0 - 1] == cells[g0] and cells[g1 - 1] == cells[g1]
    ids_e = ids[g0:g1].contiguous()
    mat = st.material[g0:g1].contiguous()
    bounds = gridops.csr_bounds(ids_e, solver.spec)
    fl, bd = (mat == 1).to(torch.float32), (mat == 0).to(torch.float32)
    x = st.x[g0:g1]
    pos = neighbors.pack4(x, bd if mode == "bvol" else fl * st.mass[g0:g1]
                          + bd * (1000.0 * st.volume[g0:g1]))
    vel = neighbors.pack4(st.v[g0:g1], st.density[g0:g1] + 1.0)
    aux = neighbors.pack_aux(torch.linspace(0.0, 1.0, g1 - g0), fl * st.mass[g0:g1],
                             st.mass[g0:g1])
    fn = getattr(neighbors, f"{mode}_sweep")
    args = ((pos,) if mode in ("density", "bvol") else (pos, vel, aux)) + (
        ids_e, bounds, mat, solver.spec, solver.params)
    full = fn(*args)
    w = g1 - g0
    for row0, n in ((0, w), (0, w // 3), (w // 3, w // 3), (w - w // 4, w // 4), (w // 2, 0)):
        part = fn(*args, rows=(row0, n))
        assert part.shape == (n,) + tuple(full.shape[1:])
        assert torch.equal(part, full[row0:row0 + n]), (row0, n)
    assert full.abs().sum() > 0
    with pytest.raises(ValueError, match="outside"):
        fn(*args, rows=(w - 1, 2))


def _sweep_case():
    """A sorted 3D state with fluid and boundary rows, seeded velocities
    and its packs: (solver, ids, bounds, material, {mode: args})."""
    raw = _raw(0.04)
    raw["fluidBlocks"][0].update(start=[0.1] * 3, end=[0.6, 0.5, 0.6])
    raw["boundaryBlocks"] = [{"start": [0.6, 0.1, 0.3], "end": [0.72, 0.3, 0.5]}]
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cpu")
    st = solver.bind(pt.build_state(scene, device="cpu", extra_capacity=16))
    st, ids, _, bounds = pt.models.wcsph.cuda_bounds.sort_and_bound(st, solver.spec)
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.normal(size=tuple(st.v.shape)).astype(np.float32))
    fl, bd = st.fluid_mask.to(torch.float32), st.boundary_mask.to(torch.float32)
    pos = neighbors.pack4(st.x, fl * st.mass + bd * (1000.0 * st.volume))
    vel = neighbors.pack4(v, st.density + 1.0)
    aux = neighbors.pack_aux(torch.linspace(0.0, 1.0, st.capacity), fl * st.mass, st.mass)
    base = (ids, bounds, st.material, solver.spec, solver.params)
    args = {m: ((neighbors.pack4(st.x, bd),) if m == "bvol" else (pos,) if m == "density"
                else (pos, vel, aux)) + base
            for m in ("density", "bvol", "force", "force_react", "reaction")}
    return st, ids, args


@pytest.mark.parametrize("mode", ["density", "bvol", "force", "force_react", "reaction"])
def test_plain_sweep_with_a_row_map(mode):
    """Kernel A's plain version with an i-row map equals the sweep over
    every row gathered at the map's rows, on a map that skips rows on
    both sides of a cell's boundary, lists rows out of order and ends in
    an inactive row."""
    st, ids, args = _sweep_case()
    fn = getattr(neighbors, f"{mode}_sweep")
    full = fn(*args[mode])
    n = st.num_active
    # every third live row, reversed in pairs, then the first inactive row
    keep = torch.arange(0, n - n % 6, 3).reshape(-1, 2).flip(1).reshape(-1)
    irows = torch.cat([keep, torch.tensor([n])]).to(torch.int32)
    cells = ids[irows.long()]
    assert bool((cells[1:] != cells[:-1]).any()) and bool((torch.diff(keep) < 0).any())
    got = fn(*args[mode], rows=irows)
    assert got.shape == (irows.numel(),) + tuple(full.shape[1:])
    assert torch.equal(got, full[irows.long()])
    assert got.abs().sum() > 0 and bool((got[-1] == 0).all())
    with pytest.raises(ValueError, match="i-row map"):
        fn(*args[mode], rows=irows.long())


@pytest.mark.parametrize("mode", ["density", "force"])
def test_plain_linear_sweep_over_a_row_range(mode):
    """Kernel C's plain version over rows [row0, row0 + n) equals those rows
    of its sweep over every row, whether its blocks start on the full
    sweep's (row0 a multiple of 128) or not: a row's pairs are the ids
    inside its stencil, whatever its block's window."""
    st, ids, args = _sweep_case()
    fn = getattr(neighbors, f"{mode}_sweep_linear")
    full = fn(*args[mode])
    for row0, n in ((384, 500), (200, 700), (0, st.capacity)):
        part = fn(*args[mode], rows=(row0, n))
        assert torch.equal(part, full[row0:row0 + n]), (row0, n)
    assert torch.equal(full, getattr(neighbors, f"{mode}_sweep")(*args[mode]))
    with pytest.raises(ValueError, match="row range"):
        fn(*args[mode], rows=torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_linear_matches_single_device_bitwise(n):
    """layout="linear" on n shards: kernel C's plain version over each
    shard's rows of its window; every field bitwise the single-device
    linear run's."""
    scene = pt.scene_from_dict(_raw(0.04))
    single = pt.WCSPH(scene, device="cpu", layout="linear")
    want = single.rollout(single.bind(pt.build_state(scene, device="cpu")), 5)
    solver = ShardedWCSPH(scene, _cpu(n), layout="linear")
    got = solver.gather_state(solver.rollout(solver.bind(pt.build_state(scene, device="cpu")),
                                             5))
    for f in gridops.state_fields(want):
        assert torch.equal(getattr(got, f)[:want.capacity], getattr(want, f)), f


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_linear_matches_jax_sharded_linear(n):
    """Against tisph_tpu's ShardedWCSPH on its linear layout
    (``_step_fn_windowed``, domain.py:891), its TPU kernel in interpret
    mode, at test_parallel.py:66-71's tolerances."""
    raw = _raw(0.04)
    scene, state, start = _tagged_start(raw)
    js = JShardedWCSPH(scene, jax_mesh(n), sweep_cfg=SweepConfig(
        impl="pallas", layout="linear", interpret=True, block_size=128, window_cap=1152,
        tile=128))
    jst = js.bind(state)
    for _ in range(5):
        jst = js.step(jst)
    solver, shards = _port_sharded(raw, n, start, 5, layout="linear")
    _close(pt.state_to_host(solver.gather_state(shards)), jax_to_host(jax.device_get(jst)))


def test_sharded_linear_refusals(tmp_path):
    """The linear layout runs at R=1 only, and not with dynamic bodies (as
    the single-device solvers)."""
    scene = pt.scene_from_dict(_raw(0.04))
    with pytest.raises(ValueError, match="R = 1"):
        ShardedWCSPH(scene, _cpu(2), layout="linear", resort_every=2)
    with pytest.raises(ValueError, match="dynamic body"):
        ShardedWCSPH(_rigid_raw(tmp_path), _cpu(2), layout="linear")


def test_make_mesh_never_falls_back_to_the_cpu():
    """tisph_tpu's make_mesh falls back to the virtual CPU devices; the
    port's raises without CUDA devices, and places shards only where the
    caller says."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh()
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and all(d.type == "cpu" for d in mesh.devices)
    with pytest.raises(ValueError, match="2 devices given for 3"):
        make_mesh(3, devices=["cpu", "cpu"])


def test_one_shard_is_the_single_device_solver_bitwise():
    scene = pt.scene_from_dict(_raw(0.04))
    single = pt.WCSPH(scene, device="cpu", resort_every=2)
    want = single.rollout(single.bind(pt.build_state(scene, device="cpu")), 4)
    solver = ShardedWCSPH(scene, _cpu(1), resort_every=2)
    got = solver.gather_state(solver.rollout(
        solver.bind(pt.build_state(scene, device="cpu")), 4))
    n = want.capacity
    for f in gridops.state_fields(want):
        assert torch.equal(getattr(got, f)[:n], getattr(want, f)), f


@pytest.mark.cuda
def test_kernel_row_range_on_cuda(tmp_path):
    """Kernel A over a row range: every mode against its plain version on
    the same rows (phase 4's tolerances of chip_smoke.py), bitwise equal
    to those rows of the whole-array launch when both launches give a row
    the same lanes, and the whole-array default unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps

    raw = _raw(0.04)
    raw["fluidBlocks"][0].update(start=[0.1] * 3, end=[0.6, 0.5, 0.6])
    raw["boundaryBlocks"] = [{"start": [0.6, 0.1, 0.3], "end": [0.72, 0.3, 0.5]}]
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cuda")
    st = solver.bind(pt.build_state(scene, device="cuda"))
    st, ids, _, bounds = pt.models.wcsph.cuda_bounds.sort_and_bound(st, solver.spec)
    gen = torch.Generator(device="cpu").manual_seed(5)
    v = st.v + 0.5 * torch.randn(tuple(st.v.shape), generator=gen).to("cuda")
    fl, bd = st.fluid_mask.to(torch.float32), st.boundary_mask.to(torch.float32)
    pos = neighbors.pack4(st.x, fl * st.mass + bd * (1000.0 * st.volume))
    pos_b = neighbors.pack4(st.x, bd)
    vel = neighbors.pack4(v, st.density + 1.0)
    aux = neighbors.pack_aux(torch.linspace(0.0, 1.0, st.capacity, device="cuda"),
                             fl * st.mass, st.mass)
    n = st.capacity
    for mode in ("density", "bvol", "force", "force_react", "reaction"):
        p = pos_b if mode == "bvol" else pos
        args = ((p,) if mode in ("density", "bvol") else (p, vel, aux)) + (
            ids, bounds, st.material, solver.spec, solver.params, False)
        kern, plain = getattr(cuda_sweeps, f"{mode}_sweep"), getattr(neighbors, f"{mode}_sweep")
        full = kern(*args)
        assert torch.equal(full, kern(*args, rows=(0, n)))
        for row0, rows in ((0, n // 3), (n // 3, n // 3), (n - 200, 200)):
            got = kern(*args, rows=(row0, rows))
            want = plain(*args, rows=(row0, rows))
            assert got.shape == want.shape
            if cuda_sweeps.launch_shape(mode, rows)[0] == cuda_sweeps.launch_shape(mode, n)[0]:
                assert torch.equal(got, full[row0:row0 + rows])
            scale = want.abs().max().clamp(min=1e-30)
            torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=5e-6)


@pytest.mark.cuda
def test_kernels_over_part_of_the_arrays_on_cuda():
    """Kernel A with an i-row map against its plain version (phase 4's
    tolerances), bitwise its range launch over the same rows; kernel C
    over a row range against its plain version, and bitwise the same rows
    of its whole-array launch when the blocks align."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels have no CPU mode")
    from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps

    st, ids, args = _sweep_case()
    cuda = {m: tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in arg)
            for m, arg in args.items()}
    n = st.capacity
    irows = torch.arange(n // 4, n // 4 + n // 2, dtype=torch.int32, device="cuda")
    for mode, a in cuda.items():
        kern, plain = getattr(cuda_sweeps, f"{mode}_sweep"), getattr(neighbors, f"{mode}_sweep")
        got = kern(*a, False, rows=irows)
        assert torch.equal(got, kern(*a, False, rows=(n // 4, n // 2)))
        want = plain(*a, rows=irows)
        scale = want.abs().max().clamp(min=1e-30)
        torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=5e-6)
    for mode in ("density", "force"):
        kern = getattr(cuda_sweeps, f"{mode}_sweep_linear")
        plain = getattr(neighbors, f"{mode}_sweep_linear")
        full = kern(*cuda[mode], False)
        part = kern(*cuda[mode], False, rows=(256, n - 300))
        assert torch.equal(part, full[256:n - 44])
        want = plain(*cuda[mode], rows=(256, n - 300))
        scale = want.abs().max().clamp(min=1e-30)
        torch.testing.assert_close(part / scale, want / scale, rtol=0, atol=5e-6)


@pytest.mark.cuda
def test_sharded_linear_on_cuda_matches_single_device():
    """Two and four shards on one card on the linear layout: bitwise the
    single-device linear run on that card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    scene = pt.scene_from_dict(_raw(0.02))
    single = pt.WCSPH(scene, device="cuda", layout="linear")
    want = single.rollout(single.bind(pt.build_state(scene, device="cuda")), 4)
    for n in (2, 4):
        solver = ShardedWCSPH(scene, make_mesh(devices=["cuda:0"] * n), layout="linear")
        got = solver.gather_state(solver.rollout(
            solver.bind(pt.build_state(scene, device="cuda")), 4))
        for f in gridops.state_fields(want):
            assert torch.equal(getattr(got, f)[:want.capacity], getattr(want, f)), f


@pytest.mark.cuda
def test_sharded_on_cuda_matches_single_device():
    """Two and four shards on one card against WCSPH on that card, R=2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    scene = pt.scene_from_dict(_raw(0.02))
    single = pt.WCSPH(scene, device="cuda", resort_every=2)
    want = single.rollout(single.bind(pt.build_state(scene, device="cuda")), 6)
    for n in (2, 4):
        solver = ShardedWCSPH(scene, make_mesh(devices=["cuda:0"] * n), resort_every=2)
        got = solver.gather_state(solver.rollout(
            solver.bind(pt.build_state(scene, device="cuda")), 6))
        _close(pt.state_to_host(got), pt.state_to_host(want))
