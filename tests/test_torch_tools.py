"""The port's tools (``python -m tisph_tpu_torch.tools.<name>``) on the CPU,
against tisph_tpu:

- soak ``--cpu`` on tests/test_torch_solver.py's 3D scene: the JAX tool's
  record keys (tools/soak.py run on the same scene), ``nan_count`` 0;
- compare_resort: its R=2 trajectory against tisph_tpu's seg solver at R=2
  in interpret mode by object_id at x atol 1e-5 (the JAX tool on the CPU
  runs the blocked sweeps, which ignore R, so it cannot be the yardstick),
  and its RMSE within 2e-5 m of the one from tisph_tpu's R=1 and R=2 runs;
- compare_compat: the per-snapshot RMSE of both solvers on a small 2D
  scene within 2e-5 m of tools/compare_compat.py::run's;
- without a card and without ``--cpu`` a tool raises; ``__version__``.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops.neighbors import SweepConfig

import tisph_tpu_torch as pt
from tisph_tpu_torch.tools import compare_compat, compare_resort, soak

from test_torch_solver import SCENE

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))

import compare_compat as jax_compare_compat  # noqa: E402
import soak as jax_soak  # noqa: E402

torch.set_num_threads(2)

SCENE_2D = {
    "configuration": {
        "dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [1.0, 1.0],
        "particleRadius": 0.02, "density0": 1000,
        "gravitation": [0.0, -9.81], "c_s": 50.0,
    },
    "boundaryBlocks": [{"start": [0.6, 0.1], "end": [0.8, 0.3]}],
    "fluidBlocks": [{"start": [0.15, 0.15], "end": [0.55, 0.55], "velocity": [0.2, -1.0]}],
}


def _write(tmp_path, raw, name="scene.json"):
    path = tmp_path / name
    path.write_text(json.dumps(raw))
    return str(path)


def test_soak_record_has_the_jax_keys(tmp_path, monkeypatch):
    path = _write(tmp_path, SCENE)
    out = tmp_path / "soak.json"
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = soak.main([path, "--steps", "6", "--chunk", "4", "--cpu", "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())
    chunks = [ln for ln in printed.getvalue().splitlines() if "particle-steps/s" in ln]
    assert len(chunks) == 2  # steps 0-4 and 4-6

    monkeypatch.setattr(sys, "argv", ["soak.py", path, "--steps", "2", "--cpu"])
    with contextlib.redirect_stdout(io.StringIO()) as jax_printed:
        assert jax_soak.main() == 0
    want = json.loads(jax_printed.getvalue()[jax_printed.getvalue().index("{"):])
    assert set(rec) == set(want)
    assert rec["regrow_events"] == [] and rec["device"] == "cpu"
    assert rec["steps"] == 6 and rec["resort_every"] == 2
    assert rec["particles"] == want["particles"] == rec["metrics"]["num_active"]
    assert rec["metrics"]["nan_count"] == 0
    assert rec["sim_seconds"] == pytest.approx(want["sim_seconds"] * 3)


def _jax_run(resort, steps):
    """tisph_tpu's trajectory of SCENE with object_id = start row: R=2 on
    its seg sweeps in interpret mode, R=1 on its default CPU sweeps; x and
    material of the start rows by that row."""
    scene = tt.scene_from_dict(SCENE)
    state = tt.build_state(scene)
    n = state.capacity
    if resort == 2:
        solver = tt.WCSPH(scene, sweep_cfg=SweepConfig(
            impl="pallas", block_size=128, window_cap=512, tile=128, interpret=True,
            layout="seg", pad_capacity=8192, resort_every=2))
        state = solver.bind(jax_pad(state, 2048))
    else:
        solver = tt.WCSPH(scene)
        state = solver.bind(state)
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    host = jax_to_host(solver.rollout(state, steps))
    order = np.argsort(host["object_id"])[:n]
    return host["x"][order], host["material"][order]


def test_compare_resort_matches_jax_seg(tmp_path):
    steps = 6
    x2, m2 = compare_resort.roll(pt.scene_from_dict(SCENE), 2, steps, "cpu")
    jx2, jm2 = _jax_run(2, steps)
    np.testing.assert_array_equal(m2, jm2)
    np.testing.assert_allclose(x2, jx2, rtol=0, atol=1e-5)

    out = compare_resort.compare(_write(tmp_path, SCENE), 2, steps, "cpu")
    jx1, jm1 = _jax_run(1, steps)
    act = jm1 == 1
    d = np.linalg.norm(jx1[act] - jx2[act], axis=-1)
    h = tt.scene_from_dict(SCENE).support_length
    assert out["h"] == h and out["resort_every"] == 2 and out["steps"] == steps
    assert abs(out["rmse"] - float(np.sqrt((d ** 2).mean()))) < 2e-5
    assert out["rmse_over_h"] == pytest.approx(out["rmse"] / h)
    assert out["rmse"] > 0  # R=2 is not R=1 (tisph_tpu's blocked CPU sweeps would give 0)


@pytest.mark.parametrize("solver", ["wcsph", "legacy"])
def test_compare_compat_matches_jax(tmp_path, solver):
    path = _write(tmp_path, SCENE_2D)
    frames, substeps = 3, 2
    out = compare_compat.compare(path, solver, frames, substeps, "cpu")
    xs_int, st_int = jax_compare_compat.run(path, "reference", solver, frames, substeps, True)
    xs_ref, _ = jax_compare_compat.run(path, "reference-exact", solver, frames, substeps, True)
    active = np.asarray(st_int.fluid_mask)
    diff2 = np.sum((np.asarray(xs_int) - np.asarray(xs_ref)) ** 2, axis=-1)
    want = np.sqrt(np.where(active[None], diff2, 0.0).sum(axis=1) / max(active.sum(), 1))
    got = [row["rmse"] for row in out["rows"]]
    assert [row["step"] for row in out["rows"]] == [2, 4, 6]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert out["rmse_final"] == got[-1]
    if solver == "wcsph":
        assert got[-1] > 1e-4  # pressure 0 against the intended EOS


def test_tools_need_the_card_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(tmp_path, SCENE)
    for tool in (soak, compare_resort, compare_compat):
        with pytest.raises(RuntimeError, match="--cpu"):
            tool.main([path])


def test_version():
    assert isinstance(pt.__version__, str)
    assert pt.__version__ == tt.__version__
