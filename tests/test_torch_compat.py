"""compat="reference-exact" on the port: the reference's shipped V2 bug
(compute_densities overwrites the neighbour sum with the self term,
wcsphv2.py:29-34, so the EOS clamp pins density to rho0 and pressure to
exactly 0), as tests/test_compat_exact.py holds it for tisph_tpu, on
scenes/demo_2d.json on the CPU; a 10-step reference-exact trajectory
against tisph_tpu's at x atol 1e-5 by object_id; and run_scene's
--compat reaching the solver."""

import dataclasses
import glob
import json
import os

import numpy as np
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import state_to_host as jax_to_host

import tisph_tpu_torch as pt
from tisph_tpu_torch import run_scene
from tisph_tpu_torch.render.export import load_frame

torch.set_num_threads(2)

DEMO_2D = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scenes", "demo_2d.json")


def _by_id(host):
    order = np.argsort(host["object_id"])
    return {k: np.asarray(v)[order] for k, v in host.items() if k != "num_active"}


def _rollout(compat, steps):
    """demo_2d on the port's CPU path, every particle tagged by its row in
    object_id (no part of the plain solver's physics)."""
    scene = pt.load_scene(DEMO_2D)
    solver = pt.WCSPH(scene, compat=compat, device="cpu")
    state = solver.bind(pt.build_state(scene, device="cpu"))
    state = dataclasses.replace(state, object_id=torch.arange(state.capacity, dtype=torch.int32))
    return scene, _by_id(pt.state_to_host(solver.rollout(state, steps)))


def test_v2_reference_exact_pressure_is_zero():
    scene, state = _rollout("reference-exact", steps=10)
    # overwritten density clamps to rho0 for every particle => p == 0
    np.testing.assert_allclose(state["density"], scene.density0, rtol=1e-6)
    np.testing.assert_allclose(state["pressure"], 0.0, atol=1e-6)


def test_v2_reference_exact_diverges_from_intended():
    _, exact = _rollout("reference-exact", steps=40)
    _, intended = _rollout("reference", steps=40)
    d = np.linalg.norm(exact["x"] - intended["x"], axis=-1)
    # without pressure the dam compresses: measurable divergence, no NaN
    assert np.isfinite(exact["x"]).all()
    assert d.max() > 1e-4
    assert np.abs(intended["pressure"]).max() > 0.0


def test_reference_exact_trajectory_matches_jax():
    scene = tt.load_scene(DEMO_2D)
    solver = tt.WCSPH(scene, compat="reference-exact")  # the blocked jnp sweeps on the CPU
    state = solver.bind(tt.build_state(scene))
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    start = jax_to_host(state)
    want = _by_id(jax_to_host(solver.rollout(state, 10)))

    port = pt.WCSPH(pt.load_scene(DEMO_2D), compat="reference-exact", device="cpu")
    got = _by_id(pt.state_to_host(port.rollout(port.bind(pt.state_from_host(start, "cpu")), 10)))
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_array_equal(got["material"], want["material"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["pressure"], 0.0)
    assert np.abs(got["x"] - _by_id(start)["x"]).max() > 1e-3


def test_run_scene_passes_compat(tmp_path, capsys):
    scene = {
        "configuration": {"dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [1.0, 1.0],
                          "particleRadius": 0.02, "density0": 1000,
                          "gravitation": [0.0, -9.81], "c_s": 50.0},
        "fluidBlocks": [{"start": [0.2, 0.2], "end": [0.5, 0.5], "velocity": [0.0, -1.0]}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(scene))
    rc = run_scene.main([str(path), "--steps", "2", "--substeps", "2", "--metrics-every", "1",
                         "--compat", "reference-exact", "--out", str(tmp_path / "frames"),
                         "--device", "cpu"])
    assert rc == 0
    assert "compat=reference-exact" in capsys.readouterr().out
    frames = sorted(glob.glob(str(tmp_path / "frames" / "frame_*.npz")))
    assert len(frames) == 2
    np.testing.assert_array_equal(load_frame(frames[-1])["pressure"], 0.0)
