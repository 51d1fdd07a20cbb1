"""Port rigid-body parity on the CPU:

- ``integrate_rigid_fields`` and ``_rotation_matrix`` against tisph_tpu's
  on seeded inputs, in 2D and 3D: one and two bodies, a wall hit, and
  rotation angles |omega dt| on both sides of the series branch (1e-4);
  atol 1e-6, rtol 1e-5 (float32 sums over the particles in another order);
- tests/test_rigid_dynamics.py's shape soak (5,000 steps of free tumble)
  and free fall (50 coupled steps without fluid), on the port;
- ``rigid_from_host`` takes tisph_tpu's RigidState fields and round-trips.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.config import SolverParams as JParams
from tisph_tpu.models import rigid as jrigid
from tisph_tpu.models.wcsph_rigid import WCSPHRigid as JWCSPHRigid

import tisph_tpu_torch as pt
from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.geometry.mesh import box_mesh, save_obj
from tisph_tpu_torch.models import rigid

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)

# (bodies, dt, |omega| scale, wall hit): |omega dt| 2e-5 (series branch)
# and 5e-2 (closed form)
CASES = {
    "one_body_small_angle": (1, 2e-4, 0.1, False),
    "two_bodies_large_angle": (2, 1e-2, 5.0, False),
    "wall_hit": (2, 2e-4, 3.0, True),
}


def _inputs(dim, bodies, omega_scale, wall, seed):
    """Seeded particles: ``bodies`` dynamic bodies (object ids 0..K-1), a
    static boundary body and fluid rows, with random reactions on every
    row (the integrator must mask them to its bodies)."""
    rng = np.random.default_rng(seed)
    per = 24
    centers = [np.array([0.3, 0.5, 0.4])[:dim], np.array([0.7, 0.6, 0.5])[:dim]]
    if wall:  # body 0 reaches through the padding below y = 0.04
        centers[0] = np.array([0.5, 0.05, 0.5])[:dim]
    x, oid, mat = [], [], []
    for k in range(bodies):
        x.append(centers[k] + rng.uniform(-0.05, 0.05, (per, dim)))
        oid += [k] * per
        mat += [0] * per
    x.append(rng.uniform(0.2, 0.8, (per, dim)))  # a static boundary body
    oid += [bodies] * per
    mat += [0] * per
    x.append(rng.uniform(0.1, 0.9, (2 * per, dim)))  # fluid
    oid += [bodies + 1] * (2 * per)
    mat += [1] * (2 * per)
    x = np.concatenate(x).astype(np.float32)
    n = x.shape[0]
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32) * 1e-3
    omega = np.zeros((bodies, 3), np.float32)
    if dim == 3:
        omega[:] = rng.normal(0.0, omega_scale, (bodies, 3))
    else:
        omega[:, 2] = rng.normal(0.0, omega_scale, bodies)
    host = {
        "x": x,
        "v": rng.normal(0.0, 0.3, (n, dim)).astype(np.float32),
        "mass": mass,
        "object_id": np.asarray(oid, np.int32),
        "boundary": np.asarray(mat) == 0,
        "reactions": rng.normal(0.0, 1e-2, (n, dim)).astype(np.float32),
    }
    sel = [(host["object_id"] == k) for k in range(bodies)]
    rig = {
        "object_ids": np.arange(bodies, dtype=np.int32),
        "mass": np.asarray([mass[s].sum() for s in sel], np.float32),
        "com": np.stack([(x[s] * mass[s, None]).sum(0) / mass[s].sum() for s in sel]
                        ).astype(np.float32),
        "v_com": rng.normal(0.0, 0.2, (bodies, dim)).astype(np.float32),
        "omega": omega,
    }
    return host, rig


def _params(dim, dt):
    kw = dict(dim=dim, dt=dt, padding=0.04, domain_start=(0.0,) * dim,
              domain_end=(1.0,) * dim, gravity=(0.0, -9.81, 0.0)[:dim])
    return JParams(**kw), SolverParams(**kw)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dim", [2, 3])
def test_integrate_rigid_fields_matches_jax(dim, case):
    bodies, dt, omega_scale, wall = CASES[case]
    host, rig = _inputs(dim, bodies, omega_scale, wall, seed=dim * 10 + bodies)
    jp, tp = _params(dim, dt)
    jx, jv, jr = jrigid.integrate_rigid_fields(
        jnp.asarray(host["x"]), jnp.asarray(host["v"]), jnp.asarray(host["mass"]),
        jnp.asarray(host["object_id"]), jnp.asarray(host["boundary"]),
        jrigid.RigidState(**{k: jnp.asarray(a) for k, a in rig.items()}),
        jnp.asarray(host["reactions"]), jp)
    tx, tv, tr = rigid.integrate_rigid_fields(
        torch.tensor(host["x"]), torch.tensor(host["v"]), torch.tensor(host["mass"]),
        torch.tensor(host["object_id"]), torch.tensor(host["boundary"]),
        rigid.rigid_from_host(rig, "cpu"), torch.tensor(host["reactions"]), tp)
    got, want = rigid.rigid_to_host(tr), {k: np.asarray(getattr(jr, k)) for k in rig}
    for k in ("com", "v_com", "omega"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    body = host["object_id"] < bodies
    assert np.array_equal(tx.numpy()[~body], host["x"][~body])  # only body rows move
    assert np.array_equal(tv.numpy()[~body], host["v"][~body])
    angle = np.linalg.norm(rig["omega"] * dt, axis=1)
    assert (angle < 1e-4).all() if omega_scale < 1 else (angle > 1e-4).all()
    if wall:  # pushed out of the padding, y velocity reflected
        assert got["com"][0, 1] > rig["com"][0, 1] + dt * rig["v_com"][0, 1]
        assert np.sign(got["v_com"][0, 1]) == -np.sign(rig["v_com"][0, 1])


@pytest.mark.parametrize("phi", [[2e-5, -1e-5, 3e-5], [0.3, -0.2, 0.5], [0.0, 0.0, 1.2]],
                         ids=["series", "closed_form", "z_axis"])
def test_rotation_matrix_matches_jax(phi):
    got = rigid._rotation_matrix(torch.tensor(phi, dtype=torch.float32)).numpy()
    want = np.asarray(jrigid._rotation_matrix(jnp.asarray(phi, jnp.float32)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-6)  # orthogonal


def _box_scene(tmp_path, lo, hi, gravity, fluid=()):
    save_obj(box_mesh(lo, hi), tmp_path / "box.obj")
    raw = {
        "configuration": {"dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
                          "particleRadius": 0.025, "density0": 1000,
                          "gravitation": gravity, "c_s": 40.0},
        "rigidBodies": [{"geometryFile": str(tmp_path / "box.obj"), "scale": [1, 1, 1],
                         "translation": [0, 0, 0], "rotationAngle": 0,
                         "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
                         "density": 1000.0, "color": [150, 150, 150], "isDynamic": True}],
        "fluidBlocks": list(fluid),
    }
    (tmp_path / "scene.json").write_text(json.dumps(raw))
    return tmp_path / "scene.json"


def test_long_run_shape_preservation(tmp_path):
    """tests/test_rigid_dynamics.py::test_long_run_shape_preservation on the
    port: 5,000 steps of free tumble at |omega| ~ 21.5 rad/s keep every
    particle's distance to the COM within 1e-4 (the exact Rodrigues
    rotation; a linearised update drifts ~4e-3)."""
    scene = pt.load_scene(_box_scene(tmp_path, (0.45,) * 3, (0.55,) * 3, [0.0, 0.0, 0.0]))
    solver = pt.WCSPHRigid(scene, device="cpu")
    state = solver.bind(pt.build_state(scene, device="cpu"))
    rg = dataclasses.replace(solver.init_rigid(state),
                             omega=torch.tensor([[12.0, 16.0, 8.0]]))
    sel = (state.object_id == 0) & state.boundary_mask
    com0 = rg.com[0].clone()
    d0 = torch.linalg.vector_norm(state.x[sel] - com0, dim=1)
    zero = torch.zeros_like(state.x)
    st = state
    for _ in range(5000):
        st, rg = rigid.integrate_rigid(st, rg, zero, solver.params)
    assert (rg.com[0] - com0).abs().max() < 1e-4
    drift = (torch.linalg.vector_norm(st.x[sel] - rg.com[0], dim=1) - d0).abs().max()
    assert drift < 1e-4, f"rigid shape drift {float(drift):.2e} over 5000 steps"
    assert (st.x[sel] - state.x[sel]).abs().max() > 0.01


def test_free_fall_without_fluid(tmp_path):
    """tests/test_rigid_dynamics.py::test_free_fall_without_fluid on the
    port's coupled rollout (bvol, density and force_react sweeps with no
    fluid): the body falls at g without spin or drift and keeps its
    shape."""
    scene = pt.load_scene(_box_scene(tmp_path, (0.45, 0.7, 0.45), (0.55, 0.8, 0.55),
                                     [0.0, -9.81, 0.0]))
    solver = pt.WCSPHRigid(scene, device="cpu")
    state = solver.bind(pt.build_state(scene, device="cpu"))
    rg = solver.init_rigid(state)
    y0 = float(rg.com[0, 1])
    state, rg = solver.rollout_coupled(state, rg, 50)
    t = 50 * solver.params.dt
    np.testing.assert_allclose(float(rg.v_com[0, 1]), -9.81 * t, rtol=1e-3)
    assert abs(float(rg.v_com[0, 0])) < 1e-4 and abs(float(rg.v_com[0, 2])) < 1e-4
    assert float(rg.com[0, 1]) < y0
    assert rg.omega.abs().max() < 1e-3
    sel = (state.object_id == 0) & state.boundary_mask
    assert torch.linalg.vector_norm(state.x[sel] - rg.com[0], dim=1).max() < 0.12
    # per-step volumes: body rows carry 1 / delta, not the fluid V0
    assert (state.volume[sel] != scene.particle_volume0).all()


def test_step_coupled_is_one_rebuilt_substep(tmp_path):
    """step_coupled equals a one-step rollout_coupled bitwise; the coupled
    solver recomputes boundary volumes every substep (its bodies move), and
    make_solver dispatches it, bound, with the bodies at rest."""
    scene = pt.load_scene(_box_scene(tmp_path, (0.42, 0.35, 0.42), (0.58, 0.47, 0.58),
                                     [0.0, -9.81, 0.0],
                                     fluid=[{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.4, 0.9],
                                             "spacing": "diameter"}]))
    solver = pt.WCSPHRigid(scene, device="cpu", resort_every=2)
    state = solver.bind(pt.build_state(scene, device="cpu"))
    rg = solver.init_rigid(state)
    sa, ra = solver.step_coupled(state, rg)
    sb, rb = solver.rollout_coupled(state, rg, 1)
    assert torch.equal(sa.x, sb.x) and torch.equal(sa.volume, sb.volume)
    assert torch.equal(ra.com, rb.com) and torch.equal(ra.omega, rb.omega)
    assert torch.equal(rg.v_com, torch.zeros_like(rg.v_com))  # the input is not modified
    assert solver.boundary_mode == "per_step" and pt.WCSPH.boundary_mode == "static"
    made, st2, rg2 = pt.make_solver(scene, pt.build_state(scene, device="cpu"), device="cpu",
                                    resort_every=2)
    assert type(made) is pt.WCSPHRigid and made.resort_every == 2
    assert torch.equal(st2.x, state.x) and torch.equal(rg2.com, rg.com)
    sc, rc, _ = pt.advance(made, st2, rg2, 1)
    assert torch.equal(sc.x, sb.x) and torch.equal(rc.com, rb.com)


def test_rigid_state_from_jax_round_trips(tmp_path):
    """tisph_tpu's RigidState fields load into the port unchanged, equal
    the port's own make_rigid_state exactly, and round-trip; a wrong dtype
    is refused."""
    path = _box_scene(tmp_path, (0.42, 0.55, 0.42), (0.58, 0.67, 0.58), [0.0, -9.81, 0.0],
                      fluid=[{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.4, 0.9],
                              "spacing": "diameter"}])
    jscene = tt.load_scene(path)
    jsolver = JWCSPHRigid(jscene)
    jr = jax.device_get(jsolver.init_rigid(jsolver.bind(tt.build_state(jscene))))
    fields = {f.name: np.asarray(getattr(jr, f.name)) for f in dataclasses.fields(jr)}
    got = pt.rigid_from_host(fields, "cpu")
    scene = pt.load_scene(path)
    own = pt.WCSPHRigid(scene, device="cpu").init_rigid(pt.build_state(scene, device="cpu"))
    for k, a in fields.items():
        assert np.array_equal(pt.rigid_to_host(got)[k], a), k
        assert np.array_equal(pt.rigid_to_host(own)[k], a), k
    assert got.num_bodies == 1
    with pytest.raises(ValueError, match="dtype"):
        pt.rigid_from_host(fields | {"mass": fields["mass"].astype(np.float64)}, "cpu")
