"""boundary_mode as an argument of the port's solvers, as tisph_tpu takes
it: plain WCSPH under "per_step" (the Akinci boundary volumes every
substep, as the reference Taichi code does) on the 2D golden scene, 20
steps against tisph_tpu's WCSPH built the same way, x atol 1e-5 by
object_id; each solver's default; an unknown mode and WCSPHRigid with
"static" refused by both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.models.wcsph_rigid import WCSPHRigid as JWCSPHRigid

import tisph_tpu_torch as pt

from test_golden import CASES

torch.set_num_threads(2)

RAW, _ = CASES["2d_dam_break"]


def _by_id(host):
    order = np.argsort(host["object_id"])
    return {k: np.asarray(v)[order] for k, v in host.items() if k != "num_active"}


def test_per_step_wcsph_matches_jax():
    scene = tt.scene_from_dict(RAW)
    solver = tt.WCSPH(scene, boundary_mode="per_step")  # the blocked jnp sweeps on the CPU
    state = solver.bind(tt.build_state(scene))
    state = dataclasses.replace(state, object_id=jnp.arange(state.capacity, dtype=jnp.int32))
    start = jax_to_host(state)
    want = _by_id(jax_to_host(solver.rollout(state, 20)))

    port = pt.WCSPH(pt.scene_from_dict(RAW), device="cpu", boundary_mode="per_step")
    assert port.boundary_mode == "per_step"
    bound = port.bind(pt.state_from_host(start, "cpu"))
    # per_step computes no volume at bind: the boundary rows keep V0
    assert torch.equal(bound.volume, torch.tensor(start["volume"]))
    got = _by_id(pt.state_to_host(port.rollout(bound, 20)))
    body = got["material"] == 0
    assert body.sum() > 0
    np.testing.assert_array_equal(got["object_id"], want["object_id"])
    np.testing.assert_array_equal(got["material"], want["material"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["volume"][body], want["volume"][body], rtol=2e-5)
    assert (got["volume"][body] != scene.particle_volume0).all()  # computed, not V0
    assert np.abs(got["x"] - _by_id(start)["x"]).max() > 1e-3


@pytest.mark.parametrize("solver, mode, expect", [
    ("WCSPH", None, "static"),
    ("WCSPH", "per_step", "per_step"),
    ("WCSPH", "static", "static"),
    ("WCSPH", "dynamic", ValueError),
    ("WCSPHRigid", None, "per_step"),
    ("WCSPHRigid", "per_step", "per_step"),
    ("WCSPHRigid", "static", ValueError),
])
def test_boundary_mode_argument_matches_jax(solver, mode, expect):
    kw = {} if mode is None else {"boundary_mode": mode}
    port_cls = getattr(pt, solver)
    jax_cls = tt.WCSPH if solver == "WCSPH" else JWCSPHRigid
    if expect is ValueError:
        with pytest.raises(ValueError, match="boundary_mode"):
            port_cls(pt.scene_from_dict(RAW), device="cpu", **kw)
        with pytest.raises(ValueError, match="boundary_mode"):
            jax_cls(tt.scene_from_dict(RAW), **kw)
        return
    assert port_cls(pt.scene_from_dict(RAW), device="cpu", **kw).boundary_mode == expect
    assert jax_cls(tt.scene_from_dict(RAW), **kw).boundary_mode == expect
