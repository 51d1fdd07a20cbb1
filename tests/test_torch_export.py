"""The port's frame export (``render.export``) against tisph_tpu's: a frame
written by the port's FrameExporter from a state (with an inactive tail)
equals, key by key (names, dtypes, shapes, values), the frame that
``tisph_tpu.render.export.FrameExporter`` writes from the same state
carried over through ``state_to_host``; png frames draw the same image."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tisph_tpu.models.state import SimState as JState
from tisph_tpu.models.state import pad_state_capacity as jax_pad
from tisph_tpu.render.export import FrameExporter as JFrameExporter
from tisph_tpu.render.export import load_frame as jax_load_frame

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import pad_state_capacity
from tisph_tpu_torch.render.export import FrameExporter, load_frame

from test_golden import CASES

torch.set_num_threads(2)

KEYS = {"position", "velocity", "density", "pressure", "material", "color"}


def _pair(name, extra=37):
    """A golden scene's start state with seeded velocities and ``extra``
    inactive slots in the port, and the same state in tisph_tpu."""
    raw, _ = CASES[name]
    state = pt.build_state(pt.scene_from_dict(raw), device="cpu")
    rng = np.random.default_rng(0)
    state = pad_state_capacity(state, state.capacity + extra)
    v = torch.from_numpy(rng.normal(size=tuple(state.v.shape)).astype(np.float32))
    state = pt.SimState(**{k: getattr(state, k) for k in
                           ("x", "density", "pressure", "mass", "volume", "material", "color",
                            "object_id")}, v=v, num_active=state.num_active)
    host = pt.state_to_host(state)
    n = int(host.pop("num_active"))
    ref = JState(**{k: jnp.asarray(a) for k, a in host.items()},
                 num_active=jnp.asarray(n, jnp.int32))
    return pt.scene_from_dict(raw), state, jax_pad(ref, state.capacity)


def _write(exporter_cls, out, state, scene, fmt, frame=7):
    exporter = exporter_cls(str(out), fmt=fmt, scene=scene)
    exporter.save(state, frame)
    exporter.close()
    return out / f"frame_{frame:06d}.{fmt}"


@pytest.mark.parametrize("name", list(CASES))
def test_npz_frame_matches_jax(tmp_path, name):
    scene, state, ref = _pair(name)
    got = load_frame(str(_write(FrameExporter, tmp_path / "port", state, scene, "npz")))
    want = jax_load_frame(str(_write(JFrameExporter, tmp_path / "jax", ref, scene, "npz")))
    assert set(got) == set(want) == KEYS
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].shape[0] == state.num_active < state.capacity, k
        np.testing.assert_array_equal(got[k].view(np.int32), want[k].view(np.int32), err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_png_frame_matches_jax(tmp_path, name):
    import matplotlib.image

    scene, state, ref = _pair(name)
    got = matplotlib.image.imread(_write(FrameExporter, tmp_path / "port", state, scene, "png"))
    want = matplotlib.image.imread(_write(JFrameExporter, tmp_path / "jax", ref, scene, "png"))
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)
    assert (got[..., :3] < 0.9).any()  # something was drawn


def test_exporter_surfaces_a_failed_write(tmp_path):
    """An error of the writer thread is raised by the next close(): here
    the frame's file name is taken by a directory."""
    scene, state, _ = _pair("2d_dam_break")
    (tmp_path / "frame_000000.npz").mkdir()
    exporter = FrameExporter(str(tmp_path), scene=scene)
    exporter.save(state, 0)
    with pytest.raises(OSError):
        exporter.close()
