"""The port's rectangle and box decomposition (tisph_tpu_torch.parallel.
ShardedWCSPHRect) on the CPU: 4 to 9 shards on ["cpu"] * n in one process.

- against tisph_tpu's ShardedWCSPH2D on the 8 virtual devices of
  tests/conftest.py, its seg sweeps in interpret mode
  (tests/test_parallel2d.py's config), at that file's tolerances (x atol
  1e-5, v atol 5e-3, density rtol 1e-4);
- against the port's own single-device WCSPH and WCSPHRigid at the same
  tolerances: 2x2, 4x2, 3x3 (the centre shard has all eight neighbours)
  and 2x2x2 at R=1 and R=2, the slab mesh, emitters, the coupled step;
- the counterparts of tests/test_parallel2d.py's migration, corner,
  rebalance, emitter-headroom, anomaly, overflow and run() cases, and of
  tests/test_parallel3d.py's refusals; the reference-exact EOS, which
  tisph_tpu's rectangle solver skips; rows dropped by the cut raise.

Rows of two runs are matched by a tag in color[:, 0] (colour plays no
part in the physics and follows a row through every sort).
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
from tisph_tpu.parallel import ShardedWCSPH2D as JShardedWCSPH2D
from tisph_tpu.parallel import make_mesh2d as jax_mesh2d

import tisph_tpu_torch as pt
from tisph_tpu_torch.geometry.mesh import box_mesh, save_obj
from tisph_tpu_torch.ops import grid as gridops
from tisph_tpu_torch.parallel import (
    ShardedWCSPH,
    ShardedWCSPH2D,
    ShardedWCSPHRect,
    make_mesh,
    make_mesh2d,
    make_mesh3d,
)

torch.set_num_threads(2)

# tests/test_parallel2d.py::_CFG
_JCFG = dict(impl="pallas", block_size=128, window_cap=1152, tile=128, interpret=True,
             layout="seg")


def _raw(radius=0.04):
    """tests/test_parallel2d.py::_scene."""
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


def _emit_raw():
    """tests/test_parallel2d.py::_emitter_scene: the seed rectangle spans
    the domain's centre, so its seeds straddle the cuts."""
    return {
        "configuration": {
            "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1],
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0, -9.81, 0], "c_s": 50.0,
        },
        "fluidBlocks": [{"start": [0.15, 0.15, 0.15], "end": [0.55, 0.4, 0.55],
                         "velocity": [0, 0, 0], "density": 1000.0, "color": [50, 100, 200]}],
        "emitters": [{"start": [0.3, 0.8, 0.3], "end": [0.52, 0.8001, 0.52],
                      "velocity": [0, -1.0, 0], "interval": 5, "maxParticles": 256}],
    }


def _mesh(shape):
    make = make_mesh2d if len(shape) == 2 else make_mesh3d
    return make(*shape, devices=["cpu"] * int(np.prod(shape)))


def _tagged(state):
    tags = torch.arange(state.capacity, dtype=torch.float32)
    return dataclasses.replace(state, color=torch.cat([tags[:, None], state.color[:, 1:]], 1))


def _start(raw, **kw):
    scene = pt.scene_from_dict(raw)
    return scene, _tagged(pt.build_state(scene, device="cpu", **kw))


def _by_tag(st):
    """Live rows by tag; emitted rows, which share their emitter's colour,
    by their position (distinct particles are a lattice spacing apart)."""
    n = st.num_active
    xq = np.round(st.x[:n].cpu().numpy() / 0.002).astype(np.int64)
    keys = [xq[:, a] for a in range(xq.shape[1] - 1, -1, -1)] + [st.color[:n, 0].cpu().numpy()]
    order = torch.from_numpy(np.lexsort(keys)).to(st.x.device)
    return {k: getattr(st, k)[:n][order] for k in ("color", "material", "x", "v", "density")}


def _close(got, want):
    """tests/test_parallel2d.py:80-84's tolerances, live rows by tag."""
    g, w = _by_tag(got), _by_tag(want)
    assert torch.equal(g["color"][:, 0], w["color"][:, 0])
    assert torch.equal(g["material"], w["material"])
    assert float((g["x"] - w["x"]).abs().max()) < 1e-5
    torch.testing.assert_close(g["v"], w["v"], rtol=0, atol=5e-3)
    torch.testing.assert_close(g["density"], w["density"], rtol=1e-4, atol=0)


def _healthy(solver, shards):
    m = solver.metrics(shards)
    assert m["nan_count"] == 0
    assert m["occ_halo"] == 0, "halo buffer overflowed"
    assert m["migrate_anomalies"] == 0
    assert m["dropped_rows"] == 0
    return m


def _homes(solver, shards):
    """Per shard: (live mask, cell coordinates, owned mask) of its rows."""
    spec = solver.spec
    out = []
    for s, st in enumerate(shards):
        coords = gridops.cell_coords(st.x, spec)
        lin, _ = solver._shard_of(coords)
        out.append((st.active_mask, coords, lin == s))
    return out


def _jax_live(jst):
    """tisph_tpu's rectangle state (inactive rows between its shards) as a
    port state of its live rows."""
    live = np.asarray(jst.material) != -1
    host = {k: np.asarray(getattr(jst, k))[live] for k in (
        "x", "v", "density", "pressure", "mass", "volume", "material", "color", "object_id")}
    return pt.state_from_host(host | {"num_active": np.asarray(int(live.sum()))}, "cpu")


def _jax_tagged(raw):
    jscene = tt.scene_from_dict(raw)
    jstate = tt.build_state(jscene)
    tags = jnp.arange(jstate.capacity, dtype=jnp.float32)
    return jscene, dataclasses.replace(jstate, color=jstate.color.at[:, 0].set(tags))


def _run(solver, start, steps):
    return solver.rollout(solver.bind(start), steps)


@pytest.fixture(scope="module")
def single_runs():
    """The port's WCSPH, 5 steps at R=1 and R=2, from the tagged start."""
    scene, start = _start(_raw())
    out = {}
    for r in (1, 2):
        solver = pt.WCSPH(scene, device="cpu", resort_every=r)
        out[r] = _run(solver, start, 5)
    return scene, start, out


@pytest.mark.parametrize("shape,resort_every", [
    ((2, 2), 1), ((2, 2), 2), ((4, 2), 1), ((4, 2), 2), ((3, 3), 2), ((2, 2, 2), 1),
    ((2, 2, 2), 2)])
def test_rect_matches_single_device(single_runs, shape, resort_every):
    scene, start, want = single_runs
    solver = ShardedWCSPHRect(scene, _mesh(shape), resort_every=resort_every)
    shards = _run(solver, start, 5)
    assert [st.capacity for st in shards] == [solver.shard_rows] * solver.n_shards
    assert sum(st.num_active for st in shards) == start.num_active
    _close(solver.gather_state(shards), want[resort_every])
    _healthy(solver, shards)


@pytest.mark.parametrize("shape", [(2, 2), (3, 2)])
def test_rect_2d_scene_matches_single_device(shape):
    """A 2D scene (tests/test_golden.py's dam break, static boundary
    volumes at bind) cut into rectangles: the R=2 run is the single-device
    one."""
    raw = {"configuration": {"dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [2.0, 1.0],
                             "particleRadius": 0.01, "density0": 1000,
                             "gravitation": [0.0, -9.81], "c_s": 50.0},
           "boundaryBlocks": [{"start": [0.9, 0.08], "end": [1.1, 0.3]}],
           "fluidBlocks": [{"start": [0.1, 0.1], "end": [0.6, 0.6], "velocity": [1.0, 0.0],
                            "density": 1000.0, "color": [50, 100, 200]}]}
    scene, start = _start(raw)
    single = pt.WCSPH(scene, device="cpu", resort_every=2)
    want = _run(single, start, 10)
    solver = ShardedWCSPHRect(scene, _mesh(shape), resort_every=2)
    shards = _run(solver, start, 10)
    _close(solver.gather_state(shards), want)
    _healthy(solver, shards)


def test_3x3_centre_shard_exchanges_with_eight_neighbours(single_runs):
    """The centre of a 3x3 mesh sends and receives along both directions of
    both axes, and its extended array holds every occupied cell within
    one cell of its rectangle, corner cells (which ride the y stage, then
    the x stage) among them."""
    scene, start, _ = single_runs
    solver = ShardedWCSPHRect(scene, _mesh((3, 3)))
    shards = solver.bind(start)
    assert all(solver._neighbour(4, a, d) is not None for a in (0, 1) for d in (-1, 1))
    shards, caches = solver._build(shards)
    assert all(src is not None for stage in caches[4].stages for src in stage)
    assert _assert_covers(solver, shards, caches, [4])[4] > 0, "no corner cell is occupied"


def test_rect_matches_jax_rect():
    """Against tisph_tpu's ShardedWCSPH2D on a 2x2 mesh of the virtual CPU
    devices, its seg kernel in interpret mode (test_parallel2d.py:64)."""
    raw = _raw()
    jscene, jstate = _jax_tagged(raw)
    js = JShardedWCSPH2D(jscene, jax_mesh2d(2, 2), sweep_cfg=SweepConfig(**_JCFG))
    jst = js.bind(jstate)
    for _ in range(5):
        jst = js.step(jst)
    want = _jax_live(jax.device_get(jst))
    scene, start = _start(raw)
    solver = ShardedWCSPH2D(scene, _mesh((2, 2)))
    shards = solver.rollout(solver.bind(start), 5)
    _close(solver.gather_state(shards), want)


def test_rect_matches_slab_mesh():
    """test_parallel2d.py:90: a 4x2 mesh reproduces the 8-shard slab mesh."""
    scene, start = _start(_raw())
    slab = ShardedWCSPH(scene, make_mesh(devices=["cpu"] * 8))
    want = slab.gather_state(_run(slab, start, 5))
    rect = ShardedWCSPHRect(scene, _mesh((4, 2)))
    _close(rect.gather_state(_run(rect, start, 5)), want)


def test_migration_moves_particles_between_shards():
    """test_parallel2d.py:138: after a step every live row is within one
    cell of its owner rectangle (the rebuild placed it, the last advect
    may have moved it by less than a cell), some row did cross a cut, and
    one more build brings every row home."""
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh((2, 4)))
    shards = solver.bind(start)
    res = torch.tensor(solver.spec.res)
    crossed = False
    for _ in range(6):
        shards = solver.step(shards)
        for s, (act, coords, home) in enumerate(_homes(solver, shards)):
            stray = act & ~home
            crossed |= bool(stray.any())
            near = torch.zeros(int(stray.sum()), dtype=torch.bool)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    c = coords[stray].clone()
                    c[:, 0] = torch.clamp(c[:, 0] + dx, 0, int(res[0]) - 1)
                    c[:, 1] = torch.clamp(c[:, 1] + dy, 0, int(res[1]) - 1)
                    near |= solver._shard_of(c)[0] == s
            assert near.all(), f"shard {s}: a row farther than a cell from its rectangle"
    assert crossed, "no particle crossed a cut; the test is vacuous"
    shards, _ = solver._build(shards)
    for act, _, home in _homes(solver, shards):
        assert (home | ~act).all()
    _healthy(solver, shards)


def _assert_covers(solver, shards, caches, which):
    """Each listed shard's extended ids hold every occupied cell within one
    cell of its rectangle exactly as often as the cell is occupied;
    returns per shard the rows of its halo in corner cells (outside its
    intervals along two cut axes or more)."""
    spec = solver.spec
    ids = torch.cat([gridops.flat_cell_ids(gridops.cell_coords(st.x, spec), st.material, spec)
                     for st in shards])
    occupied = torch.bincount(ids[ids < spec.num_cells], minlength=spec.num_cells)
    cells = torch.arange(spec.num_cells)
    cc = gridops.coords_from_ids(cells, spec)
    corners = {}
    for s in which:
        have = torch.bincount(caches[s].ids[caches[s].ids < spec.num_cells],
                              minlength=spec.num_cells)
        i = solver._index[s]
        near = torch.ones(spec.num_cells, dtype=torch.bool)
        outside = torch.zeros(spec.num_cells, dtype=torch.int64)
        for a in range(solver.n_ax):
            lo, hi = solver._lo[a][i[a]], solver._hi[a][i[a]]
            near &= (cc[:, a] >= lo - 1) & (cc[:, a] <= hi)
            outside += ((cc[:, a] < lo) | (cc[:, a] >= hi)).to(torch.int64)
        near &= cells == gridops.flat_cell_ids(cc, torch.zeros(len(cells), dtype=torch.int32),
                                               spec)  # real cells, not stride gaps
        assert torch.equal(have[near], occupied[near]), f"shard {s} misses cells of its halo"
        corners[s] = int(occupied[near & (outside >= 2)].sum())
    return corners


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)])
def test_corner_coverage_under_tight_buffers(shape):
    """test_parallel2d.py:203 (the corner bug: the x stage selects from the
    own rows and the received y halo, so caps measured on own edge rows
    alone drop corner cells): with the pool-exact caps every shard's
    extended array holds each occupied cell within one cell of its box."""
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh(shape))
    shards = solver.step(solver.bind(start))
    shards, caches = solver._build(shards)
    corners = _assert_covers(solver, shards, caches, range(solver.n_shards))
    assert sum(corners.values()) > 0, "no corner cell is occupied"
    assert int(solver._flags[3]) == 0


def test_rebalance_recuts_and_preserves_particles():
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh((2, 2)))
    shards = solver.rollout(solver.bind(start), 3)
    n0 = sum(st.num_active for st in shards)
    shards = solver.rebalance(shards)
    assert sum(st.num_active for st in shards) == n0
    assert sum(int(st.active_mask.sum()) for st in shards) == n0
    _healthy(solver, solver.step(shards))


def test_refusals():
    """test_parallel2d.py:259, test_parallel3d.py:174: the linear layout, a
    1-D mesh, and a mesh with more axes than the scene has dimensions."""
    scene = pt.scene_from_dict(_raw())
    with pytest.raises(ValueError, match="layouts"):
        ShardedWCSPHRect(scene, _mesh((2, 2)), layout="linear")
    with pytest.raises(ValueError, match="2- or 3-axis"):
        ShardedWCSPHRect(scene, make_mesh(devices=["cpu"] * 4))
    raw2 = {"configuration": {"dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [1.0, 1.0],
                              "particleRadius": 0.01, "density0": 1000,
                              "gravitation": [0.0, -9.81], "c_s": 50.0},
            "fluidBlocks": [{"start": [0.1, 0.1], "end": [0.4, 0.4]}]}
    with pytest.raises(ValueError, match="dim"):
        ShardedWCSPHRect(pt.scene_from_dict(raw2), _mesh((2, 2, 2)))
    with pytest.raises(ValueError, match="too small"):
        ShardedWCSPHRect(scene, _mesh((9, 2))).bind(pt.build_state(scene, device="cpu"))


def test_make_mesh2d_never_falls_back_to_the_cpu():
    """tisph_tpu's make_mesh2d and make_mesh3d fall back to the virtual CPU
    devices; the port's raise without CUDA devices."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh2d(2, 2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh3d(2, 2, 2)
    with pytest.raises(ValueError, match="3 devices given for 4"):
        make_mesh2d(2, 2, devices=["cpu"] * 3)
    assert make_mesh2d(2, 3, devices=["cpu"] * 6).shape == (2, 3)


def test_emitter_composes():
    """test_parallel2d.py:311: each shard emits the seeds it owns into its
    own tail, all or none, at the single-device cadence."""
    scene, start = _start(_emit_raw(), extra_capacity=512)
    solver = ShardedWCSPHRect(scene, _mesh((2, 2)))
    es = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
    shards, ems = solver.rollout_emit(solver.bind(start), [es], 12)
    assert ems[0].emitted == 3 * es.batch_size  # steps 0, 5, 10
    assert sum(st.num_active for st in shards) == start.num_active + ems[0].emitted
    for st in shards:  # live rows first in each shard
        assert int(st.active_mask.sum()) == st.num_active
        assert bool(st.active_mask[:st.num_active].all())
        assert torch.isfinite(st.x).all()
    # the seeds landed in several shards
    assert sum(int((st.object_id == 10_000).any()) for st in shards) > 1
    _healthy(solver, shards)


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_emitter_matches_single_device(shape):
    """test_parallel2d.py:340, test_parallel3d.py:66: R=2 rollout_emit,
    6 steps, against the single-device run."""
    scene, start = _start(_emit_raw(), extra_capacity=512)
    es = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
    single = pt.WCSPH(scene, device="cpu", resort_every=2)
    want, ems_w = single.rollout_emit(single.bind(start), [es], 6)
    solver = ShardedWCSPHRect(scene, _mesh(shape), resort_every=2)
    shards, ems = solver.rollout_emit(solver.bind(start), [es], 6)
    assert ems[0].emitted == ems_w[0].emitted == 2 * es.batch_size
    got = solver.gather_state(shards)
    assert got.num_active == want.num_active
    _close(got, want)


def test_emitter_respects_shard_headroom():
    """test_parallel2d.py:385: emit_frac=0 leaves no shard room, so no
    batch fires and the cadence counter says so."""
    scene, start = _start(_emit_raw(), extra_capacity=512)
    solver = ShardedWCSPHRect(scene, _mesh((2, 2)), emit_frac=0.0)
    es = pt.make_emitter_state(scene.emitters[0], scene, "cpu")
    shards, ems = solver.rollout_emit(solver.bind(start), [es], 12)
    assert ems[0].emitted == 0 and ems[0].step == 12
    assert sum(st.num_active for st in shards) == start.num_active
    assert sum(int(st.active_mask.sum()) for st in shards) == start.num_active


def _teleport(shards, s, count, axis, value):
    """Shard s's first ``count`` live rows moved to coordinate ``value``
    along ``axis``."""
    st = shards[s]
    x = st.x.clone()
    x[:count, axis] = value
    shards = list(shards)
    shards[s] = dataclasses.replace(st, x=x)
    return shards


def test_migration_anomaly_ratchets_home():
    """test_parallel2d.py:408: rows teleported several shards away trip the
    anomaly flag, are all kept, and ratchet one shard per rebuild home."""
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh((4, 2)))
    shards = solver.bind(start)
    n0 = sum(st.num_active for st in shards)
    shards = _teleport(shards, 0, 32, 0, 0.95)
    for _ in range(4):  # Sx = 4 needs at most 3 ratchets
        shards, _ = solver._build(shards)
    assert int(solver._flags[2]) > 0, "the teleport must trip the anomaly flag"
    assert sum(int(st.active_mask.sum()) for st in shards) == n0
    for act, _, home in _homes(solver, shards):
        assert (home | ~act).all()


def test_migration_buffer_overflow_is_lossless():
    """test_parallel2d.py:455: with a migration cap far below the migrants,
    the rows a buffer cannot take stay where they are, counted, and reach
    home over later rebuilds."""
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh((2, 4)))
    shards = solver.bind(start)
    n0 = sum(st.num_active for st in shards)
    solver.cap_m[1] = 128
    shards = _teleport(shards, 1, min(300, shards[1].num_active), 1, 0.55)
    for _ in range(6):
        shards, _ = solver._build(shards)
        assert sum(int(st.active_mask.sum()) for st in shards) == n0
    assert int(solver._flags[2]) > 0
    for act, _, home in _homes(solver, shards):
        assert (home | ~act).all()


def test_dropped_rows_raise():
    """The fixed cut drops the rows a shard cannot hold; tisph_tpu notices
    only in run(), the port's every rollout raises."""
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh((2, 2)))
    shards = solver.bind(start)
    # every live row of shard 3 into shard 2's rectangle: more than its rows
    x = gridops.cell_coords(shards[2].x[:1], solver.spec)
    target = (float(x[0, 1]) + 0.5) * solver.spec.cell_size
    shards = _teleport(shards, 3, shards[3].num_active, 1, target)
    assert shards[2].num_active + shards[3].num_active > solver.shard_rows
    with pytest.raises(RuntimeError, match="dropped"):
        solver.rollout(shards, 1)


def _rigid_scene(tmp_path):
    """tests/test_parallel2d.py:499's coupled scene."""
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


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_coupled_matches_wcsph_rigid(tmp_path, shape):
    """test_parallel2d.py:499, test_parallel3d.py:108: the coupled rollout,
    each body's sums added over the shards, against WCSPHRigid's."""
    scene = _rigid_scene(tmp_path)
    start = _tagged(pt.build_state(scene, device="cpu"))
    single = pt.WCSPHRigid(scene, device="cpu")
    st1 = single.bind(start)
    st1, rg1 = single.rollout_coupled(st1, single.init_rigid(st1), 3)
    solver = ShardedWCSPHRect(scene, _mesh(shape))
    assert solver.boundary_mode == "per_step"
    shards = solver.bind(start)
    rg0 = solver.init_rigid(shards)
    shards, rg2 = solver.rollout_coupled(shards, rg0, 3)
    _close(solver.gather_state(shards), st1)
    torch.testing.assert_close(rg2.com, rg1.com, rtol=0, atol=1e-6)
    torch.testing.assert_close(rg2.v_com, rg1.v_com, rtol=0, atol=1e-4)
    torch.testing.assert_close(rg2.omega, rg1.omega, rtol=0, atol=1e-4)
    assert float((rg2.v_com - rg0.v_com).abs().max()) > 0  # the body moved


def test_run_steers_rebalance_under_drift():
    """test_parallel2d.py:574: a tiny warn fraction makes run() rebalance,
    and the run goes on without a loss."""
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh((2, 2)), balance_slack=1.2)
    shards = solver.bind(start)
    n0 = sum(st.num_active for st in shards)
    calls = []
    rebalance = solver.rebalance
    solver.rebalance = lambda sh: calls.append(1) or rebalance(sh)
    shards = solver.run(shards, 8, check_every=4, warn_frac=0.05)
    assert len(calls) >= 1
    assert sum(st.num_active for st in shards) == n0
    assert solver.metrics(shards)["nan_count"] == 0


def test_run_deepens_migration_caps_on_overflow():
    """test_parallel2d.py:605: run() reads the migration trips and deepens
    the migration caps."""
    scene, start = _start(_raw())
    solver = ShardedWCSPHRect(scene, _mesh((2, 4)))
    shards = solver.bind(start)
    n0 = sum(st.num_active for st in shards)
    solver.cap_m[1] = 128
    shards = _teleport(shards, 1, min(300, shards[1].num_active), 1, 0.55)
    shards = solver.run(shards, 4, check_every=1)
    assert solver.cap_m[1] > 128, "run() never deepened the migration caps"
    assert sum(st.num_active for st in shards) == n0
    assert solver.metrics(shards)["nan_count"] == 0


def test_run_deepens_halo_caps_on_overflow(single_runs):
    """A halo cap below a cell layer's rows trips occ_halo; run() reads it
    and doubles the halo caps until the flag stays down, after which the
    run from the start is the single-device one."""
    scene, start, want = single_runs
    solver = ShardedWCSPHRect(scene, _mesh((2, 2)))
    shards = solver.bind(start)
    solver.cap_h = [128, 128]
    shards = solver.rollout(shards, 1)
    assert solver.metrics(shards)["occ_halo"] == 1  # a cell layer holds more rows
    solver.reset_flags()
    solver.run(shards, 4, check_every=1)
    assert min(solver.cap_h) > 128, "run() never deepened the halo caps"
    got = solver.rollout(solver.shard_state(start), 5)
    _close(solver.gather_state(got), want[1])
    _healthy(solver, got)


def test_reference_exact_eos_is_the_single_device_one():
    """Under compat="reference-exact" the port's rectangle step overwrites
    the fluid density with m W(0) as single-device WCSPH does; tisph_tpu's
    ShardedWCSPH2D calls tait_pressure directly and skips it
    (domain2d.py:947), a fault of the reference: its density differs from
    its own single-device one, while the port's equals tisph_tpu's WCSPH."""
    raw = _raw()
    jscene, jstate = _jax_tagged(raw)
    j_single = tt.WCSPH(jscene, compat="reference-exact")
    want = pt.state_from_host(jax_to_host(j_single.rollout(j_single.bind(jstate), 3)), "cpu")
    js = JShardedWCSPH2D(jscene, jax_mesh2d(2, 2), compat="reference-exact",
                         sweep_cfg=SweepConfig(**_JCFG))
    jst = js.bind(jstate)
    for _ in range(3):
        jst = js.step(jst)
    j_rect = _jax_live(jax.device_get(jst))
    scene, start = _start(raw)
    solver = ShardedWCSPHRect(scene, _mesh((2, 2)), compat="reference-exact")
    _close(solver.gather_state(solver.rollout(solver.bind(start), 3)), want)
    w, j = _by_tag(want), _by_tag(j_rect)
    fluid = w["material"] == 1
    gap = float((j["density"][fluid] - w["density"][fluid]).abs().max())
    assert gap > 1e-2 * raw["configuration"]["density0"], gap


@pytest.mark.cuda
def test_rect_on_cuda_matches_single_device():
    """A 2x2 and a 2x2x2 mesh on one card against WCSPH on that card, R=2;
    every sweep launched with an i-row map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    from tisph_tpu_torch.utils import profiling

    scene = pt.scene_from_dict(_raw(0.02))
    start = pt.build_state(scene, device="cuda")
    tags = torch.arange(start.capacity, dtype=torch.float32, device="cuda")
    start = dataclasses.replace(start, color=torch.cat([tags[:, None], start.color[:, 1:]], 1))
    single = pt.WCSPH(scene, device="cuda", resort_every=2)
    want = single.rollout(single.bind(start), 6)
    for shape in ((2, 2), (2, 2, 2)):
        make = make_mesh2d if len(shape) == 2 else make_mesh3d
        solver = ShardedWCSPHRect(scene, make(*shape, devices=["cuda:0"] * int(np.prod(shape))),
                                  resort_every=2)
        shards = solver.bind(start)
        before = profiling.counters().get("part_launches.density_sweep", 0)
        got = solver.gather_state(solver.rollout(shards, 6))
        assert (profiling.counters()["part_launches.density_sweep"] - before
                == 6 * solver.n_shards)
        _close(got, want)
