"""Emitter parity on the CPU: tests/test_aux.py's four TestEmitter cases
run through tisph_tpu and tisph_tpu_torch from the same start state.

- R=1 against tisph_tpu's default CPU solver (blocked jnp sweeps); R=2
  against its seg rollout with the TPU kernel in interpret mode
  (SweepConfig(..., interpret=True, resort_every=2), test_aux.py:297-304);
  layout="linear" against its linear-layout kernel in interpret mode.
- Each holds num_active, emitted and step exactly; the rows that carry a
  unique id (every row of the start state) matched by object_id; the
  emitted rows (all id 10,000) matched by least normalised cost; x atol
  1e-5 on both.
- A row emitted inside an R-group keeps its density, gets no acceleration
  and flies at its emission velocity until the next rebuild.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.geometry import emitter as jem
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops.neighbors import SweepConfig

import tisph_tpu_torch as pt
from tisph_tpu_torch.geometry import emitter as pem
from tisph_tpu_torch.models.state import pad_state_capacity

torch.set_num_threads(2)

EMITTED = jem.EMITTER_OBJECT_ID


def _scene(interval=7, max_particles=40, velocity=(0.0, -1.0), fluid_start=(0.5, 0.3),
           fluid_end=(0.9, 0.6), emit_start=(1.0, 1.5), emit_end=(1.08, 1.5001)):
    """tests/test_aux.py's emitter scene."""
    return {
        "configuration": {"dim": 2, "domainStart": [0, 0], "domainEnd": [2, 2],
                          "particleRadius": 0.02, "density0": 1000,
                          "gravitation": [0, -9.81], "c_s": 50.0},
        "fluidBlocks": [{"start": list(fluid_start), "end": list(fluid_end),
                         "velocity": [0, 0], "density": 1000.0, "color": [50, 100, 200]}],
        "emitters": [{"start": list(emit_start), "end": list(emit_end),
                      "velocity": list(velocity), "interval": interval,
                      "maxParticles": max_particles}],
    }


def _jax_solver(scene, resort, layout="seg"):
    if resort == 2:
        return tt.WCSPH(scene, sweep_cfg=SweepConfig(
            impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
            layout="seg", pad_capacity=8192, resort_every=2))
    if layout == "linear":
        return tt.WCSPH(scene, sweep_cfg=SweepConfig(
            impl="pallas", block_size=128, window_cap=1024, tile=128, interpret=True,
            layout="linear", fast_math=False))
    return tt.WCSPH(scene)  # the blocked jnp sweeps on the CPU


def _start(raw, resort, layout="seg", extra=128):
    """tisph_tpu's solver and its bound start state with a unique
    object_id per row, and the port's copy of that state (capacity and
    pool rows included)."""
    scene = tt.scene_from_dict(raw)
    solver = _jax_solver(scene, resort, layout)
    state = tt.build_state(scene, extra_capacity=extra)
    if resort == 2:
        state = jax_pad(state, 1536)
    state = solver.bind(state)
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    port_state = pad_state_capacity(pt.state_from_host(jax_to_host(state), "cpu"),
                                    state.capacity)
    return scene, solver, state, port_state


def _check_emitter(got, want):
    assert (got.step, got.emitted) == (int(want.step), int(want.emitted))
    assert got.interval == int(want.interval)
    assert got.max_particles == int(want.max_particles)


def _check_states(got_state, want_state, atol=1e-5):
    """num_active exact; unique-id rows by id, emitted rows by least
    normalised cost, x atol ``atol``."""
    assert got_state.num_active == int(want_state.num_active)
    got, want = pt.state_to_host(got_state), jax_to_host(want_state)
    for host in (got, want):
        assert (host["material"] == 1).sum() + (host["material"] == 0).sum() == len(host["x"])
    em_g, em_w = got["object_id"] == EMITTED, want["object_id"] == EMITTED
    assert em_g.sum() == em_w.sum()
    og = np.argsort(got["object_id"][~em_g])
    ow = np.argsort(want["object_id"][~em_w])
    np.testing.assert_array_equal(got["object_id"][~em_g][og], want["object_id"][~em_w][ow])
    np.testing.assert_allclose(got["x"][~em_g][og], want["x"][~em_w][ow], rtol=0, atol=atol)
    if em_g.any():
        xg, xw = got["x"][em_g].astype(np.float64), want["x"][em_w].astype(np.float64)
        vg, vw = got["v"][em_g].astype(np.float64), want["v"][em_w].astype(np.float64)
        cost = np.maximum(np.abs(xg[:, None] - xw[None]).max(-1) / atol,
                          np.abs(vg[:, None] - vw[None]).max(-1) / 5e-2)
        best = cost.argmin(axis=1)
        assert len(np.unique(best)) == len(best), "emitted rows do not match one to one"
        np.testing.assert_allclose(xg, xw[best], rtol=0, atol=atol)
        assert (got["material"][em_g] == 1).all()
    return got, want


def test_emission_into_pool():
    """test_aux.py::test_emission_into_pool: three maybe_emit calls (due,
    not due, due) write the same rows in both packages."""
    raw = _scene(interval=2, max_particles=64, velocity=(0.0, -2.0), fluid_start=(0.5, 0.5),
                 fluid_end=(0.7, 0.7), emit_start=(1.0, 1.8), emit_end=(1.1, 1.8001))
    scene = tt.scene_from_dict(raw)
    js = tt.build_state(scene, extra_capacity=256)
    jes = jem.make_emitter_state(scene.emitters[0], scene)
    pscene = pt.scene_from_dict(raw)
    ps = pt.build_state(pscene, device="cpu", extra_capacity=256)
    pes = pem.make_emitter_state(pscene.emitters[0], pscene, "cpu")
    assert ps.capacity == js.capacity and pes.batch_size == jes.batch_size > 0
    n0, b = ps.num_active, pes.batch_size
    x0, before = ps.x, ps.x.clone()
    for k in range(3):
        js, jes = jem.maybe_emit(js, jes, scene.particle_volume0)
        ps, pes = pem.maybe_emit(ps, pes, pscene.particle_volume0)
        _check_emitter(pes, jes)
        assert ps.num_active == int(js.num_active) == n0 + b * (1 + k // 2)
        for f in pem.EMIT_FIELDS:
            np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f)
    assert (ps.x[n0:n0 + b, 1] > 1.7).all()
    assert (ps.material[n0:n0 + 2 * b] == 1).all()
    # the port writes out of place: the caller's tensors keep their rows
    assert torch.equal(x0, before)


def test_emitted_particles_simulate():
    """test_aux.py::test_emitted_particles_simulate: 30 steps of maybe_emit
    then step, as a host loop in both packages."""
    raw = _scene(interval=10, max_particles=40)
    scene, solver, js, ps = _start(raw, resort=1)
    port = pt.WCSPH(pt.scene_from_dict(raw), device="cpu")
    ps = port.bind(ps)
    jes = jem.make_emitter_state(scene.emitters[0], scene)
    pes = pem.make_emitter_state(port.scene.emitters[0], port.scene, "cpu")
    for _ in range(30):
        js, jes = jem.maybe_emit(js, jes, scene.particle_volume0)
        js = solver.step(js)
        ps, pes = pem.maybe_emit(ps, pes, port.scene.particle_volume0)
        ps = port.step(ps)
    _check_emitter(pes, jes)
    assert pes.emitted > 0
    got, _ = _check_states(ps, js)
    assert np.isfinite(got["x"]).all()


@pytest.mark.parametrize("layout", ["seg", "linear"])
def test_rollout_emit_matches_per_step_loop(layout):
    """test_aux.py::test_rollout_emit_matches_per_step_loop at R=1 (seg
    against the blocked sweeps, linear against the linear TPU kernel in
    interpret mode): rollout_emit equals the port's own host loop bitwise
    and tisph_tpu's rollout_emit at x atol 1e-5."""
    raw = _scene(interval=7, max_particles=40)
    steps = 20 if layout == "seg" else 8
    scene, solver, js, ps0 = _start(raw, resort=1, layout=layout)
    jes = jem.make_emitter_state(scene.emitters[0], scene)
    want, (jes_w,) = solver.rollout_emit(js, [jes], steps)

    port = pt.WCSPH(pt.scene_from_dict(raw), device="cpu", layout=layout)
    ps0 = port.bind(ps0)
    pes0 = pem.make_emitter_state(port.scene.emitters[0], port.scene, "cpu")
    got, (pes,) = port.rollout_emit(ps0, [pes0], steps)
    _check_emitter(pes, jes_w)
    assert pes.emitted > 0
    _check_states(got, want)

    sa, ea = ps0, pes0
    for _ in range(steps):
        sa, ea = pem.maybe_emit(sa, ea, port.scene.particle_volume0)
        sa = port.step(sa)
    assert (ea.step, ea.emitted, sa.num_active) == (pes.step, pes.emitted, got.num_active)
    assert torch.equal(sa.x, got.x)


def test_rollout_emit_amortized_matches_manual_schedule():
    """test_aux.py::test_rollout_emit_amortized_matches_manual_schedule at
    R=2: one rebuild per group, then emit + apply each substep.  The port's
    rollout_emit equals its manual schedule bitwise and tisph_tpu's seg
    rollout_emit at x atol 1e-5; the emission cadence is exact."""
    raw = _scene(interval=7, max_particles=40)
    scene, solver, js, ps0 = _start(raw, resort=2)
    jes = jem.make_emitter_state(scene.emitters[0], scene)
    steps = 10
    want, (jes_w,) = solver.rollout_emit(js, [jes], steps)

    port = pt.WCSPH(pt.scene_from_dict(raw), device="cpu", resort_every=2)
    ps0 = port.bind(ps0)
    pes0 = pem.make_emitter_state(port.scene.emitters[0], port.scene, "cpu")
    got, (pes,) = port.rollout_emit(ps0, [pes0], steps)
    _check_emitter(pes, jes_w)
    assert pes.emitted > 0
    _check_states(got, want)

    vol0 = port.scene.particle_volume0
    sa, ea = ps0, pes0
    for _ in range(steps // 2):
        sa, cache = port._build(sa)
        for _ in range(2):
            sa, ea = pem.maybe_emit(sa, ea, vol0)
            sa = port._apply(sa, cache)
    assert (ea.emitted, sa.num_active) == (pes.emitted, got.num_active)
    assert torch.equal(sa.x, got.x)


def test_mid_group_emission_flies_ballistically():
    """A batch emitted on a group's second substep (interval 3 at R=2:
    emissions at steps 0 and 3) joins no sweep until the next rebuild: its
    density stays the emitter's, its velocity the emission velocity
    exactly (no gravity), and it moves by dt v.  Handing the plain sweeps
    the current material instead gives these rows gravity."""
    raw = _scene(interval=3, max_particles=0)
    port = pt.WCSPH(pt.scene_from_dict(raw), device="cpu", resort_every=2)
    state = port.bind(pt.build_state(port.scene, device="cpu", extra_capacity=128))
    es = pem.make_emitter_state(port.scene.emitters[0], port.scene, "cpu")
    b, n0 = es.batch_size, state.num_active
    got, (es2,) = port.rollout_emit(state, [es], 4)  # groups (0, 1) and (2, 3)
    assert es2.emitted == 2 * b and es2.step == 4
    new = slice(n0 + b, n0 + 2 * b)  # the batch of step 3
    assert torch.equal(got.v[new], es.velocity.expand(b, 2))
    assert torch.equal(got.density[new], torch.full((b,), 1000.0))
    assert torch.equal(got.x[new], es.seeds_x + port.params.dt * got.v[new])
    # ... and JAX does the same with the same schedule
    scene, solver, js, ps0 = _start(raw, resort=2)
    jes = jem.make_emitter_state(scene.emitters[0], scene)
    want, _ = solver.rollout_emit(js, [jes], 4)
    port2 = pt.WCSPH(pt.scene_from_dict(raw), device="cpu", resort_every=2)
    got2, _ = port2.rollout_emit(port2.bind(ps0), [pem.make_emitter_state(
        port2.scene.emitters[0], port2.scene, "cpu")], 4)
    g, w = _check_states(got2, want)
    last = slice(int(want.num_active) - b, int(want.num_active))
    np.testing.assert_array_equal(np.asarray(want.v)[last], np.tile([0.0, -1.0], (b, 1)))
    np.testing.assert_array_equal(g["v"][-b:], w["v"][-b:])


def test_dynamic_body_with_emitters_raises(tmp_path):
    """tisph_tpu's run_scene drops the emitters of a scene with a dynamic
    body; the port refuses the scene."""
    from tisph_tpu.geometry.mesh import box_mesh, save_obj

    save_obj(box_mesh((0.42, 0.35, 0.42), (0.58, 0.47, 0.58)), tmp_path / "box.obj")
    raw = {
        "configuration": {"dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
                          "particleRadius": 0.04},
        "rigidBodies": [{"geometryFile": "box.obj", "scale": [1, 1, 1], "translation": [0, 0, 0],
                         "density": 400.0, "isDynamic": True}],
        "fluidBlocks": [{"start": [0.1] * 3, "end": [0.9, 0.4, 0.9], "velocity": [0, 0, 0]}],
        "emitters": [{"start": [0.5, 0.8, 0.5], "end": [0.6, 0.8001, 0.6],
                      "velocity": [0, -1, 0], "interval": 5}],
    }
    scene = pt.scene_from_dict(raw, base_dir=str(tmp_path))
    with pytest.raises(ValueError, match="emitters"):
        pt.make_solver(scene, pt.build_state(scene, device="cpu"), device="cpu")
    solver = pt.WCSPH(scene, device="cpu")
    state = solver.bind(pt.build_state(scene, device="cpu"))
    with pytest.raises(ValueError, match="emit"):
        pt.advance(solver, state, object(), 1, [])
