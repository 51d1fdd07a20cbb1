"""Port solver parity on the CPU (plain sweeps):

- R=2 rollout against tisph_tpu's seg rollout (TPU kernel in interpret
  mode, resort_every=2), and R=1 against its default CPU (blocked) solver,
  both compared by object_id (sort order may differ once positions differ
  by an ulp) at x atol 1e-5 (tests/test_seg.py:395);
- the golden trajectories at tests/test_golden.py's tolerances;
- run_scene writes frames tisph_tpu.render.export.load_frame reads.
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
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops.neighbors import SweepConfig
from tisph_tpu.render.export import load_frame

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
    raw, steps = CASES[name]
    scene = pt.scene_from_dict(raw)
    solver = pt.WCSPH(scene, device="cpu", resort_every=1)
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
    ref = jax_to_host(tt.build_state(tt.scene_from_dict(SCENE)))
    assert set(frame) == set(ref)
    for k in ref:
        assert frame[k].dtype == ref[k].dtype and frame[k].shape == ref[k].shape, k
    assert np.isfinite(frame["x"]).all()
    assert int(jax.device_get(frame["num_active"])) == int(ref["num_active"])
