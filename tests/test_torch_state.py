"""Port state parity: build_state gives the arrays tisph_tpu builds, the
host dict round-trips in both directions, and padding matches."""

import numpy as np
import pytest
import torch

import jax
import tisph_tpu as tt
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.models.state import state_to_host as jax_to_host

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import pad_state_capacity

from test_golden import SCENE_2D, SCENE_3D
from test_pallas import _scene

torch.set_num_threads(2)

FIELDS = ("x", "v", "density", "pressure", "mass", "volume", "material",
          "color", "object_id")


def _assert_host_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("raw", [SCENE_2D, SCENE_3D], ids=["golden2d", "golden3d"])
def test_build_state_matches_jax(raw):
    ref = tt.build_state(tt.scene_from_dict(raw))
    got = pt.build_state(pt.scene_from_dict(raw), device="cpu")
    assert got.capacity == ref.capacity and got.num_active == int(ref.num_active)
    full = jax.device_get(ref)
    for k in FIELDS:  # whole capacity, padding included
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(full, k)),
                                      err_msg=k)


def test_host_round_trip():
    """JAX state_to_host -> port state_from_host -> port state_to_host is
    the identity, field names and dtypes included."""
    host = jax_to_host(tt.build_state(_scene(dim=3)))
    _assert_host_equal(pt.state_to_host(pt.state_from_host(host, "cpu")), host)


def test_pad_state_capacity_matches_jax():
    ref = tt.build_state(tt.scene_from_dict(SCENE_2D))
    port = pt.build_state(pt.scene_from_dict(SCENE_2D), device="cpu")
    cap = ref.capacity + 37
    got = pad_state_capacity(port, cap)
    want = jax.device_get(jax_pad(ref, cap))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.num_active == port.num_active


def test_state_from_host_rejects_bad_input():
    host = jax_to_host(tt.build_state(_scene(dim=2)))
    bad = dict(host, material=host["material"].astype(np.int64))
    with pytest.raises(ValueError, match="dtype"):
        pt.state_from_host(bad, "cpu")
    short = dict(host, x=host["x"][:-1])
    with pytest.raises(ValueError, match="rows"):
        pt.state_from_host(short, "cpu")
