"""The frame dump, ``tisph_tpu_torch.models.state.state_to_host``.

On the CPU, on a 2D and a 3D state with padding rows: the dump is each
field's live rows, bitwise, with its dtype and shape, and
``state_from_host`` rebuilds those rows from it (the CPU spans:
``tests/test_torch_tracing.py``).

Marked ``cuda`` (skipped here), on demo states stepped on the card: the
dump equals the pageable ``t[:n].cpu().numpy()`` of each field bitwise,
every array lies in pinned memory, a dump held while the state is
advanced and dumped again stays unchanged, and while recording the spans
are ``state.to_host``, ``.wait``, ``.copy``, with ``pinned=1``.
"""

import os

import numpy as np
import pytest
import torch

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import _HOST_FIELDS, pad_state_capacity
from tisph_tpu_torch.utils import profiling

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))

RAW_2D = {
    "configuration": {"dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [1.0, 1.0],
                      "particleRadius": 0.02, "density0": 1000,
                      "gravitation": [0.0, -9.81], "c_s": 88.5},
    "rigidBodies": [],
    "fluidBlocks": [{"start": [0.3, 0.1], "end": [0.5, 0.3], "velocity": [0.0, -2.0],
                     "density": 1000.0, "color": [50, 100, 200]}],
}
RAW_3D = {
    "configuration": {"dim": 3, "domainStart": [0.0, 0.0, 0.0],
                      "domainEnd": [0.6, 0.6, 0.6], "particleRadius": 0.03,
                      "density0": 1000, "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0},
    "rigidBodies": [],
    "fluidBlocks": [{"start": [0.1, 0.1, 0.1], "end": [0.3, 0.3, 0.3],
                     "velocity": [1.0, 0.0, 0.0], "density": 1000.0,
                     "color": [50, 100, 200]}],
}
ROW_BYTES = {2: 52, 3: 60}  # x, v: dim f32; five f32 and two i32 scalars; color: 3 f32


def _cpu_state(raw):
    """A CPU state whose capacity exceeds its live rows, with each field
    made distinct so a view cut at the wrong offset shows."""
    state = pt.build_state(pt.scene_from_dict(raw), device="cpu")
    state = pad_state_capacity(state, state.capacity + 13)
    g = torch.Generator().manual_seed(7)
    fields = {k: (torch.rand(getattr(state, k).shape, generator=g)
                  if getattr(state, k).is_floating_point()
                  else torch.randint(-5, 5, getattr(state, k).shape, generator=g,
                                     dtype=torch.int32))
              for k in _HOST_FIELDS}
    return pt.SimState(**fields, num_active=state.num_active)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("raw", [RAW_2D, RAW_3D], ids=["2d", "3d"])
def test_cpu_dump_is_the_live_rows(raw):
    state = _cpu_state(raw)
    n = state.num_active
    assert n < state.capacity
    host = pt.state_to_host(state)
    assert list(host) == [*_HOST_FIELDS, "num_active"]
    assert int(host["num_active"]) == n
    for k in _HOST_FIELDS:
        field = getattr(state, k)[:n]
        assert host[k].dtype == field.numpy().dtype, k
        assert host[k].shape == tuple(field.shape), k
        assert np.array_equal(_bits(host[k]), _bits(field.numpy())), k
    assert sum(host[k].nbytes for k in _HOST_FIELDS) == n * ROW_BYTES[state.dim]


@pytest.mark.parametrize("raw", [RAW_2D, RAW_3D], ids=["2d", "3d"])
def test_cpu_dump_round_trips(raw):
    state = _cpu_state(raw)
    n = state.num_active
    back = pt.state_from_host(pt.state_to_host(state), "cpu")
    assert back.num_active == n and back.capacity == n
    for k in _HOST_FIELDS:
        assert np.array_equal(_bits(getattr(back, k).numpy()),
                              _bits(getattr(state, k)[:n].numpy())), k


# -- on the card -----------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned dump runs on the card only")


def _stepped(name, steps=5):
    """The demo scene ``name`` on the card after ``steps`` steps (the 2D
    one on the legacy solver, as the benchmark's frame loop runs it)."""
    scene = pt.load_scene(os.path.join(HERE, "..", "scenes", name))
    cls = pt.WCSPHLegacy if scene.dim == 2 else pt.WCSPH
    solver = cls(scene, device="cuda", resort_every=1)
    state = solver.bind(pt.build_state(scene, device="cuda"))
    return solver, solver.rollout(state, steps)


def _pageable(state) -> dict[str, np.ndarray]:
    return {k: getattr(state, k)[: state.num_active].cpu().numpy() for k in _HOST_FIELDS}


def _assert_bitwise(got, want):
    for k in _HOST_FIELDS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo_2d.json", "demo_3d.json"])
def test_pinned_dump_equals_the_pageable_copies_on_cuda(name):
    _need_cuda()
    solver, state = _stepped(name)
    host = pt.state_to_host(state)
    assert int(host["num_active"]) == state.num_active
    _assert_bitwise(host, _pageable(state))
    for k in _HOST_FIELDS:
        assert torch.from_numpy(host[k]).is_pinned(), k


@pytest.mark.cuda
def test_held_dump_survives_later_dumps_on_cuda():
    """The harness's pattern: the previous frame's arrays are held while
    the state is advanced and dumped again, and dropped dumps free their
    pinned tensors for reuse."""
    _need_cuda()
    solver, state = _stepped("demo_3d.json")
    held = pt.state_to_host(state)
    want = {k: held[k].copy() for k in _HOST_FIELDS}
    for frame in range(4):
        state = solver.rollout(state, 5)
        new = pt.state_to_host(state)  # dropped at the next frame, as a viewer would
        assert not np.array_equal(new["x"], held["x"])
        _assert_bitwise(new, _pageable(state))
        _assert_bitwise(held, want)


@pytest.mark.cuda
def test_pinned_dump_spans_on_cuda():
    _need_cuda()
    solver, state = _stepped("demo_2d.json")
    state = solver.rollout(state, 5)  # queued: the wait has work to wait for
    with profiling.recording():
        host = pt.state_to_host(state)
    spans = profiling.recorded()
    assert [s.name for s in spans] == ["state.to_host", "state.to_host.wait",
                                       "state.to_host.copy"]
    assert spans[1].parent == 0 and spans[2].parent == 0
    assert spans[1].end_ns <= spans[2].start_ns
    fields = [host[k] for k in _HOST_FIELDS]
    assert spans[0].attrs == {"bytes": sum(a.nbytes for a in fields), "fields": 9, "pinned": 1}
