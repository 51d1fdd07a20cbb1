"""npz checkpoints between the packages, on the CPU: a file written by
either package loads in the other, with the same keys and dtypes, and
resumes to the same trajectory (x atol 1e-5 across packages, bitwise
within the port).  The cases of tests/test_aux.py::TestCheckpoint and
tests/test_rigid_dynamics.py::test_rigid_checkpoint_roundtrip, each in
both directions, and run_scene --checkpoint / --resume.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import tisph_tpu as tt
from tisph_tpu import checkpoint as jck
from tisph_tpu.geometry.emitter import make_emitter_state as jax_emitter
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.models.wcsph_rigid import WCSPHRigid as JWCSPHRigid

import tisph_tpu_torch as pt
from tisph_tpu_torch import checkpoint as pck
from tisph_tpu_torch import run_scene

from test_torch_emitter import _check_states, _scene
from test_torch_solver import _body_scene, _by_tag, _tagged

torch.set_num_threads(2)

_FIELDS = ("x", "v", "density", "pressure", "mass", "volume", "material", "color",
           "object_id")


def _jax_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in _FIELDS}


def _port_fields(state):
    return {k: getattr(state, k).numpy() for k in _FIELDS}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_roundtrip(tmp_path, writer):
    """TestCheckpoint::test_npz_roundtrip: every field over the whole
    capacity (pool rows included) and num_active survive the trip into the
    other package; both write the same keys with the same dtypes and
    shapes; a step of the restored state in the loading package equals a
    step of the saved one in the writing package (x atol 1e-5, rows matched
    by a tag in color[:, 0])."""
    scene = tt.load_scene("scenes/demo_2d.json")
    solver = tt.WCSPH(scene)
    js = _tagged(solver.step(solver.bind(tt.build_state(scene, extra_capacity=64))))
    port = pt.WCSPH(pt.load_scene("scenes/demo_2d.json"), device="cpu")
    ps = port.bind(pt.build_state(port.scene, device="cpu", extra_capacity=64))
    ps = port.step(ps)
    ps = dataclasses.replace(ps, color=ps.color.clone())
    ps.color[:, 0] = torch.arange(ps.capacity, dtype=torch.float32)
    p = tmp_path / "ckpt.npz"
    if writer == "jax":
        jck.save_npz(js, p)
        restored = pck.load_npz(p, device="cpu")
        want = _jax_fields(js)
        assert restored.num_active == int(js.num_active)
        for k in _FIELDS:
            np.testing.assert_array_equal(getattr(restored, k).numpy(), want[k], err_msg=k)
        got, ref = pt.state_to_host(port.step(restored)), jax_to_host(solver.step(js))
    else:
        pck.save_npz(ps, p)
        restored = jck.load_npz(p)
        want = _port_fields(ps)
        assert int(restored.num_active) == ps.num_active
        for k in _FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(restored, k)), want[k], err_msg=k)
        got, ref = pt.state_to_host(port.step(ps)), jax_to_host(solver.step(restored))
    np.testing.assert_allclose(_by_tag(got)["x"], _by_tag(ref)["x"], rtol=0, atol=1e-5)
    jck.save_npz(js, tmp_path / "jax.npz")
    pck.save_npz(ps, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert set(zj.files) == set(zp.files)
        for k in zj.files:
            assert (zj[k].dtype, zj[k].shape) == (zp[k].dtype, zp[k].shape), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_emitter_resume_matches_uninterrupted(tmp_path, writer):
    """TestCheckpoint::test_emitter_resume_matches_uninterrupted across
    the packages: 12 steps in the writer, save with the emitter states,
    load and 12 more in the other; the result equals the uninterrupted 24
    (emissions at 0, 7, 14, 21).  Within the port the resumed run is
    bitwise the uninterrupted one, and a fresh emitter state in place of
    the saved one breaks the cadence."""
    raw = _scene(interval=7, max_particles=80)
    scene = tt.scene_from_dict(raw)
    solver = tt.WCSPH(scene)
    js0 = solver.bind(tt.build_state(scene, extra_capacity=128))
    jes0 = jax_emitter(scene.emitters[0], scene)
    port = pt.WCSPH(pt.scene_from_dict(raw), device="cpu")
    ps0 = port.bind(pt.build_state(port.scene, device="cpu", extra_capacity=128))
    pes0 = pt.make_emitter_state(port.scene.emitters[0], port.scene, "cpu")
    p = tmp_path / "emit_ckpt.npz"

    pa, (pea,) = port.rollout_emit(ps0, [pes0], 24)
    ja, _ = solver.rollout_emit(js0, [jes0], 24)
    if writer == "jax":
        jm, jems = solver.rollout_emit(js0, [jes0], 12)
        jck.save_npz(jm, p, emitters=jems)
        sr, rigid, ems = pck.load_npz(p, with_rigid=True, with_emitters=True, device="cpu")
        assert rigid is None and len(ems) == 1 and ems[0].step == 12
        got, (eg,) = port.rollout_emit(sr, ems, 12)
        assert (eg.step, eg.emitted) == (pea.step, pea.emitted)
        _check_states(got, ja)
    else:
        pm, pems = port.rollout_emit(ps0, [pes0], 12)
        pck.save_npz(pm, p, emitters=pems)
        sr, rigid, ems = jck.load_npz(p, with_rigid=True, with_emitters=True)
        assert rigid is None and len(ems) == 1 and int(ems[0].step) == 12
        got, (eg,) = solver.rollout_emit(sr, list(ems), 12)
        assert (int(eg.step), int(eg.emitted)) == (pea.step, pea.emitted)
        _check_states(pa, got)
        # the port's own resume is bitwise its uninterrupted run
        sr2, ems2 = pck.load_npz(p, with_emitters=True, device="cpu")
        pb, (peb,) = port.rollout_emit(sr2, ems2, 12)
        assert (peb.step, peb.emitted, pb.num_active) == (pea.step, pea.emitted, pa.num_active)
        assert torch.equal(pb.x, pa.x)
        _, (pew,) = port.rollout_emit(sr2, [pes0], 12)
        assert pew.step != peb.step


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rigid_checkpoint_roundtrip(tmp_path, writer):
    """test_rigid_dynamics.py::test_rigid_checkpoint_roundtrip across the
    packages: the RigidState rides the file, and resuming in the other
    package continues the coupled run (com atol 1e-5, x atol 1e-4 as
    test_torch_solver's coupled parity); a state-only file loads with
    ``with_rigid`` as None."""
    raw = _body_scene(tmp_path, dynamic=True, radius=0.04)
    scene = tt.scene_from_dict(raw, base_dir=str(tmp_path))
    solver = JWCSPHRigid(scene)
    js = _tagged(solver.bind(tt.build_state(scene)))
    jr = solver.init_rigid(js)
    port = pt.WCSPHRigid(pt.scene_from_dict(raw, base_dir=str(tmp_path)), device="cpu")
    p = tmp_path / "ck.npz"
    if writer == "jax":
        s1, r1 = solver.rollout_coupled(js, jr, 3)
        jck.save_npz(s1, p, rigid=r1)
        s2, r2 = pck.load_npz(p, with_rigid=True, device="cpu")
        np.testing.assert_array_equal(r2.v_com.numpy(), np.asarray(r1.v_com))
        np.testing.assert_array_equal(r2.omega.numpy(), np.asarray(r1.omega))
        sa, ra = solver.rollout_coupled(s1, r1, 2)
        sb, rb = port.rollout_coupled(port.bind(s2), r2, 2)
    else:
        ps = port.bind(pt.state_from_host(jax_to_host(js), "cpu"))
        s1, r1 = port.rollout_coupled(ps, port.init_rigid(ps), 3)
        pck.save_npz(s1, p, rigid=r1)
        s2, r2 = jck.load_npz(p, with_rigid=True)
        np.testing.assert_array_equal(np.asarray(r2.v_com), r1.v_com.numpy())
        np.testing.assert_array_equal(np.asarray(r2.omega), r1.omega.numpy())
        sb, rb = port.rollout_coupled(s1, r1, 2)
        sa, ra = solver.rollout_coupled(s2, r2, 2)
    np.testing.assert_allclose(rb.com.numpy(), np.asarray(ra.com), rtol=0, atol=1e-5)
    got, want = _by_tag(pt.state_to_host(sb)), _by_tag(jax_to_host(sa))
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-4)
    pck.save_npz(s2 if writer == "jax" else sb, tmp_path / "plain.npz")
    assert pck.load_npz(tmp_path / "plain.npz", with_rigid=True, device="cpu")[1] is None
    assert jck.load_npz(tmp_path / "plain.npz", with_rigid=True)[1] is None


def test_run_scene_checkpoint_resume(tmp_path, capsys):
    """run_scene --checkpoint then --resume: 2 frames, then 2 more from
    the file, equal bitwise to 4 frames in one run, emitters included;
    tisph_tpu loads the file."""
    raw = _scene(interval=3, max_particles=40)
    scene_path = tmp_path / "scene.json"
    scene_path.write_text(json.dumps(raw))
    common = [str(scene_path), "--substeps", "3", "--resort", "2", "--metrics-every", "0",
              "--device", "cpu"]
    assert run_scene.main(common + ["--steps", "4", "--checkpoint", str(tmp_path / "a.npz")]) == 0
    assert run_scene.main(common + ["--steps", "2", "--checkpoint", str(tmp_path / "m.npz")]) == 0
    assert run_scene.main(common + ["--steps", "2", "--resume", str(tmp_path / "m.npz"),
                                    "--checkpoint", str(tmp_path / "b.npz")]) == 0
    out = capsys.readouterr().out
    assert "+ 1 emitter state(s)" in out and "emitters: 1" in out
    a, ea = pck.load_npz(tmp_path / "a.npz", with_emitters=True, device="cpu")
    b, eb = pck.load_npz(tmp_path / "b.npz", with_emitters=True, device="cpu")
    assert (ea[0].step, ea[0].emitted) == (eb[0].step, eb[0].emitted) == (12, 4 * ea[0].batch_size)
    assert a.num_active == b.num_active
    assert torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
    ja = jck.load_npz(tmp_path / "a.npz")
    np.testing.assert_array_equal(np.asarray(ja.x), a.x.numpy())
