"""WCSPHLegacy (the reference's V1 physics) on the CPU against tisph_tpu:

- 20 steps on scenes/demo_2d.json against tisph_tpu's WCSPHLegacy, x atol
  1e-5 by object_id;
- one step against the float64 V1 oracle in 2D and 3D at
  tests/test_forces_oracle.py's tolerances, with the oracle test's own
  SolverParams;
- under compat="reference-exact" a fluid particle outside the box stays
  out, and the intended mode clamps it back
  (tests/test_compat_exact.py::test_v1_reference_exact_never_clamps);
- run_scene --solver legacy, and R > 1 refused.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.config import SolverParams as JSolverParams
from tisph_tpu.models.state import state_to_host as jax_to_host

import tisph_tpu_torch as pt
from tisph_tpu_torch import run_scene

from test_forces_oracle import _mixed_state, _sorted_by_position
from tests.oracle import OracleWCSPHV1

torch.set_num_threads(2)


def _by_id(host):
    order = np.argsort(host["object_id"])
    return {k: np.asarray(v)[order] for k, v in host.items() if k != "num_active"}


def test_trajectory_matches_jax():
    scene = tt.load_scene("scenes/demo_2d.json")
    solver = tt.WCSPHLegacy(scene)
    state = solver.bind(tt.build_state(scene))
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    start = jax_to_host(state)
    want = _by_id(jax_to_host(solver.rollout(state, 20)))
    port = pt.WCSPHLegacy(pt.load_scene("scenes/demo_2d.json"), device="cpu")
    got = _by_id(pt.state_to_host(port.rollout(port.bind(pt.state_from_host(start, "cpu")), 20)))
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["density"], want["density"], rtol=2e-5)
    assert np.abs(got["x"] - _by_id(start)["x"]).max() > 1e-3


@pytest.mark.parametrize("dim", [2, 3])
def test_single_step_matches_v1_oracle(dim):
    """tests/test_forces_oracle.py::test_legacy_single_step_matches_v1_oracle
    on the port, with that test's SolverParams passed as ``params=``."""
    radius = 0.025
    lo, hi = [0.0] * dim, [1.0] * dim
    state0 = _mixed_state(dim, seed=99 + dim, radius=radius, domain_lo=lo, domain_hi=hi)
    kw = dict(dim=dim, support_length=4 * radius, particle_radius=radius, padding=4 * radius,
              domain_start=tuple(lo), domain_end=tuple(hi),
              gravity=(0.0, -9.81, 0.0)[:dim], c_s=88.5)
    params = pt.SolverParams(**kw)
    assert dataclasses.asdict(params) == dataclasses.asdict(JSolverParams(**kw))
    scene = pt.SceneConfig(dim=dim, domain_start=tuple(lo), domain_end=tuple(hi),
                           particle_radius=radius, c_s=88.5,
                           gravitation=(0.0, -9.81, 0.0)[:dim])
    solver = pt.WCSPHLegacy(scene, params=params, device="cpu")
    assert solver.params is params
    host = jax_to_host(state0)
    dev = pt.state_to_host(solver.step(solver.bind(pt.state_from_host(host, "cpu"))))

    oracle = OracleWCSPHV1(dim=dim, domain_start=lo, domain_end=hi, particle_radius=radius)
    ox, ov, orho, _, _ = oracle.step(host["x"], host["v"], host["density"], host["pressure"],
                                     host["volume"], host["material"])
    dxs, dvs, drhos = _sorted_by_position(dev["x"], dev["v"], dev["density"])
    oxs, ovs, orhos = _sorted_by_position(ox.astype(np.float32), ov, orho)
    np.testing.assert_allclose(dxs, oxs, atol=1e-5)
    np.testing.assert_allclose(dvs, ovs, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(drhos, orhos, rtol=2e-4)


def test_v1_reference_exact_never_clamps():
    """A fluid particle pushed out of the box with outward velocity stays
    out under reference-exact (no domain clamp) and is clamped back under
    the intended mode."""
    scene = pt.load_scene("scenes/demo_2d.json")
    solver = pt.WCSPHLegacy(scene, compat="reference-exact", device="cpu")
    state = solver.bind(pt.build_state(scene, device="cpu"))
    idx = int(torch.argmax((state.material == 1).to(torch.int32)))
    x, v = state.x.clone(), state.v.clone()
    x[idx, 0] = scene.domain_end[0] + 0.5
    v[idx, 0] = 5.0
    state = dataclasses.replace(state, x=x, v=v)

    def max_fluid_x(st):
        return float(st.x[st.material == 1, 0].max())

    assert max_fluid_x(solver.rollout(state, 3)) > scene.domain_end[0]  # still outside
    solver2 = pt.WCSPHLegacy(scene, compat="reference", device="cpu")
    out2 = solver2.rollout(solver2.bind(state), 3)
    assert max_fluid_x(out2) <= scene.domain_end[0] - scene.padding + 1e-5


def test_run_scene_legacy_and_refusals(tmp_path, capsys):
    """run_scene --solver legacy runs to the end with no NaN; the legacy
    solver refuses R > 1 (tisph_tpu ignores R there)."""
    raw = json.loads(open("scenes/demo_2d.json").read())
    raw["configuration"]["particleRadius"] = 0.03  # about 700 particles
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(raw))
    rc = run_scene.main([str(path), "--steps", "2", "--substeps", "3", "--metrics-every", "1",
                         "--solver", "legacy", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "solver=legacy" in out and "nan=0" in out
    scene = pt.scene_from_dict(raw)
    with pytest.raises(ValueError, match="resort_every=2"):
        pt.WCSPHLegacy(scene, device="cpu", resort_every=2)
    with pytest.raises(ValueError, match="resort_every=2"):
        run_scene.main([str(path), "--solver", "legacy", "--resort", "2", "--device", "cpu"])
