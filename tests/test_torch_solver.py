"""Port solver parity on the CPU (plain sweeps):

- R=2 rollout against tisph_tpu's seg rollout (TPU kernel in interpret
  mode, resort_every=2), and R=1 against its default CPU (blocked) solver,
  both compared by object_id (sort order may differ once positions differ
  by an ulp) at x atol 1e-5 (tests/test_seg.py:395);
- the rigid coupled rollout (WCSPHRigid) with a box body half in the
  water, R=2 against tisph_tpu's seg coupled rollout in interpret mode and
  R=1 against its blocked one: com atol 1e-5, v_com and omega atol 1e-4
  (tests/test_rigid_dynamics.py:138-151), x atol 1e-4 by a particle tag
  carried in color[:, 0], body-row volumes rtol 2e-5;
- a static mesh obstacle through plain WCSPH against tisph_tpu's WCSPH;
- the golden trajectories at tests/test_golden.py's tolerances;
- run_scene writes frames with the keys, dtypes and shapes of
  tisph_tpu.render.export.FrameExporter's, and runs a dynamic-body scene
  through the coupled solver.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.geometry.mesh import box_mesh, save_obj
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.models.wcsph_rigid import WCSPHRigid as JWCSPHRigid
from tisph_tpu.ops.neighbors import SweepConfig
from tisph_tpu.render.export import FrameExporter, load_frame

import tisph_tpu_torch as pt
from tisph_tpu_torch import run_scene

from test_golden import CASES, _golden_path

torch.set_num_threads(2)

SCENE = {
    "configuration": {
        "dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
        "particleRadius": 0.04, "density0": 1000,
        "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0,
    },
    "fluidBlocks": [{"start": [0.15] * 3, "end": [0.55] * 3,
                     "velocity": [0.2, -1.0, 0.5], "density": 1000.0,
                     "color": [50, 100, 200]}],
}  # test_pallas._scene()


def _by_id(host):
    order = np.argsort(host["object_id"])
    return {k: np.asarray(v)[order] for k, v in host.items() if k != "num_active"}


@pytest.mark.parametrize("resort", [2, 1])
def test_rollout_matches_jax(resort):
    scene = tt.scene_from_dict(SCENE)
    state = tt.build_state(scene)
    if resort == 2:
        solver = tt.WCSPH(scene, sweep_cfg=SweepConfig(
            impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
            layout="seg", pad_capacity=8192, resort_every=2))
        state = solver.bind(jax_pad(state, 2048))
    else:
        solver = tt.WCSPH(scene)  # the blocked jnp sweeps on the CPU
        state = solver.bind(state)
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    start = jax_to_host(state)
    want = _by_id(jax_to_host(solver.rollout(state, 6)))

    port = pt.WCSPH(pt.scene_from_dict(SCENE), device="cpu", resort_every=resort)
    got = _by_id(pt.state_to_host(port.rollout(port.bind(pt.state_from_host(start, "cpu")), 6)))
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_array_equal(got["material"], want["material"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5)
    assert np.abs(got["x"] - start["x"][np.argsort(start["object_id"])]).max() > 1e-3


def test_linear_rollout_matches_jax():
    """WCSPH(layout="linear") against tisph_tpu's linear-layout pallas step
    (WCSPH._step_fn_pallas, kernel in interpret mode) over 4 steps."""
    scene = tt.scene_from_dict(SCENE)
    solver = tt.WCSPH(scene, sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=1024, tile=128, interpret=True,
        layout="linear", fast_math=False))
    state = solver.bind(tt.build_state(scene))
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    start = jax_to_host(state)
    end = solver.rollout(state, 4)
    assert int(end.occ_window) <= solver.sweep_cfg.window_cap  # no window was clipped
    want = _by_id(jax_to_host(end))

    port = pt.WCSPH(pt.scene_from_dict(SCENE), device="cpu", layout="linear")
    got = _by_id(pt.state_to_host(port.rollout(port.bind(pt.state_from_host(start, "cpu")), 4)))
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5)
    assert np.abs(got["x"] - start["x"][np.argsort(start["object_id"])]).max() > 1e-3


def test_linear_layout_refuses_what_it_does_not_run(tmp_path):
    """R > 1 (tisph_tpu ignores it off the seg layout silently; the port
    raises), an unknown layout, and a dynamic body (the coupled step has no
    linear kernel)."""
    scene = pt.scene_from_dict(SCENE)
    with pytest.raises(ValueError, match="resort_every=2"):
        pt.WCSPH(scene, device="cpu", layout="linear", resort_every=2)
    with pytest.raises(ValueError, match="layouts"):
        pt.WCSPH(scene, device="cpu", layout="blocked")
    solver = pt.WCSPH(scene, device="cpu", layout="linear")
    state = solver.bind(pt.build_state(scene, device="cpu"))
    solver.resort_every = 2
    with pytest.raises(ValueError, match="resort_every=2"):
        solver.rollout(state, 2)
    raw = _body_scene(tmp_path, dynamic=True, radius=0.04)
    body = pt.scene_from_dict(raw, base_dir=str(tmp_path))
    with pytest.raises(ValueError, match="layouts"):
        pt.make_solver(body, pt.build_state(body, device="cpu"), device="cpu", layout="linear")


def _body_scene(tmp_path, dynamic, radius=0.033):
    """tests/test_rigid_dynamics.py:118-124's scene with the box lowered
    into the water (fluid top y = 0.4, box y 0.35-0.47)."""
    save_obj(box_mesh((0.42, 0.35, 0.42), (0.58, 0.47, 0.58)), tmp_path / "box.obj")
    return {
        "configuration": {"dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
                          "particleRadius": radius, "density0": 1000,
                          "gravitation": [0.0, -9.81, 0.0], "c_s": 40.0},
        "rigidBodies": [{"geometryFile": "box.obj", "scale": [1, 1, 1],
                         "translation": [0, 0, 0], "rotationAngle": 0,
                         "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
                         "density": 400.0, "color": [150, 150, 150], "isDynamic": dynamic}],
        "fluidBlocks": [{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.4, 0.9],
                         "velocity": [0, 0, 0], "density": 1000.0,
                         "color": [50, 100, 200], "spacing": "diameter"}],
    }


def _tagged(state):
    """Tag every particle with its row in color[:, 0] (exact in f32):
    object_id is the body identity here and cannot carry the tag."""
    return dataclasses.replace(
        state, color=state.color.at[:, 0].set(jnp.arange(state.capacity, dtype=jnp.float32)))


def _by_tag(host):
    order = np.argsort(host["color"][:, 0])
    return {k: np.asarray(v)[order] for k, v in host.items() if k != "num_active"}


@pytest.mark.parametrize("resort", [2, 1])
def test_coupled_rollout_matches_jax(tmp_path, resort):
    raw = _body_scene(tmp_path, dynamic=True)
    scene = tt.scene_from_dict(raw, base_dir=str(tmp_path))
    if resort == 2:
        solver = JWCSPHRigid(scene, sweep_cfg=SweepConfig(
            impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
            layout="seg", pad_capacity=0, resort_every=2, fast_math=False))
    else:
        solver = JWCSPHRigid(scene)  # the blocked jnp sweeps on the CPU
    state = _tagged(solver.bind(tt.build_state(scene)))
    rigid = solver.init_rigid(state)
    start = jax_to_host(state)
    rstart = {f.name: np.asarray(getattr(rigid, f.name)) for f in dataclasses.fields(rigid)}
    s_j, r_j = solver.rollout_coupled(state, rigid, 3)
    want, r_want = _by_tag(jax_to_host(s_j)), jax.device_get(r_j)

    port = pt.WCSPHRigid(pt.scene_from_dict(raw, base_dir=str(tmp_path)), device="cpu",
                         resort_every=resort)
    st, rg = port.rollout_coupled(port.bind(pt.state_from_host(start, "cpu")),
                                  pt.rigid_from_host(rstart, "cpu"), 3)
    got = _by_tag(pt.state_to_host(st))
    np.testing.assert_allclose(rg.com.numpy(), r_want.com, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rg.v_com.numpy(), r_want.v_com, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rg.omega.numpy(), r_want.omega, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["material"], want["material"])
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-4)
    body = got["material"] == 0
    np.testing.assert_allclose(got["volume"][body], want["volume"][body], rtol=2e-5)
    # the body is in the water: the fluid's reaction holds it against g
    free_fall = -9.81 * 3 * port.params.dt
    assert float(rg.v_com[0, 1]) > 0.8 * free_fall
    assert (got["volume"][body] != scene.particle_volume0).all()


def test_static_obstacle_matches_jax(tmp_path):
    """A box mesh with isDynamic false is a static boundary of plain WCSPH
    (volumes once at bind), as in tisph_tpu."""
    raw = _body_scene(tmp_path, dynamic=False, radius=0.04)
    scene = tt.scene_from_dict(raw, base_dir=str(tmp_path))
    solver = tt.WCSPH(scene)  # blocked jnp sweeps on the CPU
    state = _tagged(solver.bind(tt.build_state(scene)))
    start = jax_to_host(state)
    want = _by_tag(jax_to_host(solver.rollout(state, 4)))
    port, st, rigid = pt.make_solver(pt.scene_from_dict(raw, base_dir=str(tmp_path)),
                                     pt.state_from_host(start, "cpu"), device="cpu")
    assert type(port) is pt.WCSPH and port.boundary_mode == "static" and rigid is None
    got = _by_tag(pt.state_to_host(pt.advance(port, st, rigid, 4)[0]))
    np.testing.assert_array_equal(got["material"], want["material"])
    assert (got["material"] == 0).sum() > 0
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["volume"], want["volume"], rtol=2e-5)
    body = got["material"] == 0
    assert np.array_equal(got["x"][body], _by_tag(start)["x"][body])  # it never moves


def _match_golden(got, ref):
    """Each particle's recorded counterpart is the one of least cost
    max(|dx|/5e-5, |dv|/5e-2, |drho|/(5e-4 rho)), test_golden's
    tolerances: the golden file is ordered by position, and a 1-ulp
    difference reorders particles that share a coordinate, so rows cannot
    be compared by index.  Passes iff the matching is one to one and every
    cost is at most 1."""
    t = {k: (torch.as_tensor(got[k]).double(), torch.as_tensor(ref[k]).double())
         for k in ("x", "v", "density")}
    inf = float("inf")
    cost = torch.maximum(torch.cdist(*t["x"], p=inf) / 5e-5, torch.cdist(*t["v"], p=inf) / 5e-2)
    rho, rho_ref = t["density"]
    cost = torch.maximum(cost, (rho[:, None] - rho_ref[None, :]).abs() / (5e-4 * rho_ref.abs()))
    best, idx = cost.min(dim=1)
    return best.numpy(), idx.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_golden_trajectory(name):
    check_golden(name, "seg")


def test_golden_trajectory_linear_2d():
    check_golden("2d_dam_break", "linear")


def check_golden(name, layout):
    raw, steps = CASES[name]
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cpu", resort_every=1, layout=layout)
    got = pt.state_to_host(solver.rollout(solver.bind(pt.build_state(scene, device="cpu")),
                                          steps))
    with np.load(_golden_path(name)) as z:
        ref = {k: z[k] for k in z.files}
    assert got["x"].shape == ref["x"].shape
    best, idx = _match_golden(got, ref)
    assert len(np.unique(idx)) == len(idx), "matching is not one to one"
    np.testing.assert_array_equal(got["material"], ref["material"][idx])
    assert best.max() <= 1.0, f"worst particle at {best.max():.3f} of the tolerance"


def test_run_scene_writes_frames(tmp_path):
    scene_path = tmp_path / "scene.json"
    scene_path.write_text(json.dumps(SCENE))
    out = tmp_path / "frames"
    rc = run_scene.main([str(scene_path), "--steps", "2", "--substeps", "2", "--resort", "2",
                         "--metrics-every", "1", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    frames = sorted(glob.glob(str(out / "frame_*.npz")))
    assert [os.path.basename(f) for f in frames] == ["frame_000000.npz", "frame_000001.npz"]
    frame = load_frame(frames[-1])
    # the frame tisph_tpu's exporter writes from the same scene's state
    exporter = FrameExporter(str(tmp_path / "ref"))
    exporter.save(tt.build_state(tt.scene_from_dict(SCENE)), 0)
    exporter.close()
    ref = load_frame(str(tmp_path / "ref" / "frame_000000.npz"))
    assert set(frame) == set(ref) == {"position", "velocity", "density", "pressure",
                                      "material", "color"}
    for k in ref:
        assert frame[k].dtype == ref[k].dtype and frame[k].shape == ref[k].shape, k
    assert np.isfinite(frame["position"]).all()
    assert not np.array_equal(frame["position"], ref["position"])  # it moved


def test_run_scene_runs_dynamic_body(tmp_path, capsys):
    raw = _body_scene(tmp_path, dynamic=True, radius=0.04)
    scene_path = tmp_path / "scene.json"
    scene_path.write_text(json.dumps(raw))
    rc = run_scene.main([str(scene_path), "--steps", "2", "--substeps", "2", "--resort", "2",
                         "--metrics-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "dynamic rigid bodies: 1" in out and "nan=0" in out
