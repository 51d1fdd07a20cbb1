"""The legacy (V1) solver's pair sums, ``legacy_density_sweep`` and
``legacy_force_sweep`` (``tisph_tpu_torch/ops/neighbors.py``, the plain
versions of ``csrc/legacy.cu``), against the two sweeps of
``tisph_tpu``'s legacy step (``tisph_tpu/models/wcsph_legacy.py:50-93``,
its jnp path on the CPU), on numpy-seeded 2D and 3D states of a fluid
cloud over a boundary raft, with the volumes of ``boundary_mode``
``"static"`` (computed at bind) and ``"per_step"`` (every step):

- tisph_tpu's step runs eagerly with its ``neighbor_sweep`` recorded, so
  both sides read the same sorted state and the same fields;
- density: rho0 times tisph_tpu's sum on fluid rows, rtol 2e-5, and 0 on
  every other row;
- force: tisph_tpu's dv (gravity and the pair sum) on fluid rows, atol
  5e-6 of max|dv|, and 0 on every other row.

Marked ``cuda`` (skipped here): the kernel at every built lane count
against its plain version on the same states, at the same tolerances; a
lane count it is not built for raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tisph_tpu as tt
import tisph_tpu.models.wcsph_legacy as jlegacy
from tisph_tpu.config import SolverParams as JSolverParams
from tisph_tpu.models.state import MATERIAL_BOUNDARY, MATERIAL_FLUID, make_state
from tisph_tpu.models.state import state_to_host as jax_to_host

import tisph_tpu_torch as pt
from tisph_tpu_torch.ops import neighbors
from tisph_tpu_torch.ops.cuda import bounds as cuda_bounds
from tisph_tpu_torch.ops.cuda import legacy as cuda_legacy
from tisph_tpu_torch.ops.cuda import sweeps as cuda_sweeps
from tisph_tpu_torch.models.state import pad_state_capacity
from tisph_tpu_torch.ops.grid import state_fields

torch.set_num_threads(2)

RADIUS = 0.025
RTOL_DENSITY, ATOL_FORCE = 2e-5, 5e-6
# test_golden's 3D dam break: a fluid block and a boundary block
DAM_3D = {
    "configuration": {"dim": 3, "domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.6, 1.0, 1.0],
                      "particleRadius": 0.025, "density0": 1000,
                      "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0},
    "boundaryBlocks": [{"start": [0.7, 0.05, 0.3], "end": [0.9, 0.25, 0.7]}],
    "fluidBlocks": [{"start": [0.08, 0.08, 0.08], "end": [0.45, 0.5, 0.5],
                     "velocity": [1.0, 0.0, 0.0], "density": 1000.0, "color": [50, 100, 200]}],
}


def _kw(dim):
    lo, hi = (0.0,) * dim, (1.0,) * dim
    return dict(dim=dim, support_length=4 * RADIUS, particle_radius=RADIUS,
                padding=4 * RADIUS, domain_start=lo, domain_end=hi,
                gravity=(0.0, -9.81, 0.0)[:dim], c_s=88.5)


def _host_state(dim, seed):
    """A fluid cloud (about 40 neighbours inside h a row) over a raft of
    boundary rows, 8 inactive rows at the end."""
    rng = np.random.default_rng(seed)
    n_f, n_b = (200, 60) if dim == 2 else (300, 100)
    lo, hi = (0.3, 0.7) if dim == 2 else (0.35, 0.65)
    xf = rng.uniform(lo, hi, size=(n_f, dim))
    xb = rng.uniform(lo, hi, size=(n_b, dim))
    xb[:, 1] = rng.uniform(lo - 0.05, lo, size=n_b)
    x = np.concatenate([xb, xf]).astype(np.float32)
    n = n_f + n_b
    mat = np.concatenate([np.full(n_b, MATERIAL_BOUNDARY),
                          np.full(n_f, MATERIAL_FLUID)]).astype(np.int32)
    v = rng.normal(0, 0.5, size=(n, dim)).astype(np.float32)
    v[mat == MATERIAL_BOUNDARY] = 0
    rho = rng.uniform(990.0, 1030.0, size=n).astype(np.float32)
    return make_state(positions=x, velocities=v, densities=rho,
                      pressures=np.zeros(n, np.float32), materials=mat,
                      colors=np.zeros((n, 3), np.float32),
                      object_ids=np.arange(n, dtype=np.int32),
                      volume0=0.8 * (2 * RADIUS) ** dim, capacity=n + 8)


def _jax_sweeps(dim, mode, monkeypatch):
    """tisph_tpu's legacy step on the seeded state, eagerly: the bound
    state (static volumes in place) and its two sweep calls, each as
    (x_sorted, i_fields, j_fields, result)."""
    scene = tt.SceneConfig(dim=dim, domain_start=(0.0,) * dim, domain_end=(1.0,) * dim,
                           particle_radius=RADIUS, c_s=88.5,
                           gravitation=(0.0, -9.81, 0.0)[:dim])
    solver = tt.WCSPHLegacy(scene, params=JSolverParams(**_kw(dim)), boundary_mode=mode)
    state = solver.bind(_host_state(dim, 7 + dim))
    calls = []
    sweep = jlegacy.neighbor_sweep

    def record(nd, x, i_fields, j_fields, *rest):
        out = sweep(nd, x, i_fields, j_fields, *rest)
        calls.append(tuple(np.asarray(a) if not isinstance(a, dict) else
                           {k: np.asarray(v) for k, v in a.items()}
                           for a in (x, i_fields, j_fields, out)))
        return out

    monkeypatch.setattr(jlegacy, "neighbor_sweep", record)
    solver._step_fn(state)
    assert len(calls) == 2
    return jax_to_host(state), calls


def _port_inputs(dim, host, calls):
    """The port's sorted state (the same rows in the same order as
    tisph_tpu's) and the legacy packs of tisph_tpu's fields."""
    params = pt.SolverParams(**_kw(dim))
    state = pad_state_capacity(pt.state_from_host(host, "cpu"), calls[0][0].shape[0])
    spec = pt.WCSPHLegacy(pt.SceneConfig(dim=dim, domain_start=(0.0,) * dim,
                                         domain_end=(1.0,) * dim, particle_radius=RADIUS),
                          params=params, device="cpu").spec
    st, ids, _, bounds = cuda_bounds.sort_and_bound(state, spec)
    (x_d, _, jd, rho_sum), (x_f, i_f, j_f, dv) = calls
    np.testing.assert_array_equal(st.x.numpy(), x_d)
    np.testing.assert_array_equal(st.x.numpy(), x_f)
    def t(a):
        return torch.from_numpy(np.array(a))

    # the solver's packs, of tisph_tpu's step fields
    pos = neighbors.legacy_pos(st)
    vel, aux = neighbors.legacy_force_packs(
        dataclasses.replace(st, v=t(j_f["v"]), volume=t(j_f["volume"])), t(j_f["density"]),
        t(j_f["pressure"]))
    np.testing.assert_array_equal(pos[:, 3].numpy(), jd["fluid"])
    np.testing.assert_array_equal(aux[:, 2].numpy(), j_f["bound"])
    np.testing.assert_allclose(aux[:, 0].numpy(), i_f["p_rho2"], rtol=1e-6)
    fluid = st.fluid_mask.numpy()
    want = {"density": np.where(fluid, params.density0 * rho_sum["rho"], 0.0),
            "force": np.where(fluid[:, None], dv["dv"], 0.0)}
    return dict(st=st, ids=ids, bounds=bounds, spec=spec, params=params, pos=pos, vel=vel,
                aux=aux, fluid=fluid, want=want)


def _sweep(lib, inp, mode, lanes=None):
    """``lib``'s sweep in ``mode``; the kernel at ``lanes`` threads a row
    where given (``_launch``), else at its rule's."""
    args = (inp["ids"], inp["bounds"], inp["st"].material, inp["spec"], inp["params"])
    if lanes is not None:
        packs = (inp["pos"], None, None) if mode == "density" else (
            inp["pos"], inp["vel"], inp["aux"])
        return lib._launch(mode, lanes, *packs, *args)
    if mode == "density":
        return lib.legacy_density_sweep(inp["pos"], *args)
    return lib.legacy_force_sweep(inp["pos"], inp["vel"], inp["aux"], *args)


def _close(mode, got, want, fluid):
    """The tolerances of the module's docstring; rows off the fluid
    family exactly 0."""
    assert np.array_equal(got[~fluid], np.zeros_like(got[~fluid])), mode
    if mode == "density":
        np.testing.assert_allclose(got[fluid], want[fluid], rtol=RTOL_DENSITY)
    else:
        scale = np.abs(want[fluid]).max()
        assert np.abs(got[fluid] - want[fluid]).max() <= ATOL_FORCE * scale


@pytest.mark.parametrize("mode", ["static", "per_step"])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_sweeps_match_jax(dim, mode, monkeypatch):
    host, calls = _jax_sweeps(dim, mode, monkeypatch)
    inp = _port_inputs(dim, host, calls)
    fluid, st = inp["fluid"], inp["st"]
    assert fluid.sum() > 100 and (~fluid & st.active_mask.numpy()).sum() >= 60
    live = st.active_mask.numpy()
    # per_step: the step's volumes, not bind's
    same = np.array_equal(calls[1][2]["volume"][live], st.volume.numpy()[live])
    assert same == (mode == "static")
    x = st.x.numpy()[live]
    near = (((x[:, None] - x[None]) ** 2).sum(-1) < (4 * RADIUS) ** 2).sum(1) - 1
    assert np.median(near) >= 20  # neighbours inside h a row
    for m in ("density", "force"):
        _close(m, _sweep(neighbors, inp, m).numpy(), inp["want"][m], fluid)


def _card_inputs(inp):
    card = {k: (v.cuda() if isinstance(v, torch.Tensor) else v) for k, v in inp.items()
            if k not in ("st", "want", "fluid")}
    card["st"] = pt.SimState(**{k: getattr(inp["st"], k).cuda() for k in
                                state_fields(inp["st"])}, num_active=inp["st"].num_active)
    return card


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", cuda_legacy.LANES)
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_matches_plain_on_cuda(dim, lanes, monkeypatch):
    """``csrc/legacy.cu`` on the card at every built lane count against
    its plain version, per_step volumes, at the module's tolerances; two
    calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/legacy.cu runs on the card only")
    host, calls = _jax_sweeps(dim, "per_step", monkeypatch)
    inp = _port_inputs(dim, host, calls)
    card = _card_inputs(inp)
    for m in ("density", "force"):
        got, again = _sweep(cuda_legacy, card, m, lanes), _sweep(cuda_legacy, card, m, lanes)
        assert torch.equal(got, again)
        _close(m, got.cpu().numpy(), _sweep(neighbors, inp, m).numpy(), inp["fluid"])


@pytest.mark.cuda
def test_unbuilt_lanes_raise_on_cuda(monkeypatch):
    """A lane count the kernel is not built for raises: no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/legacy.cu runs on the card only")
    host, calls = _jax_sweeps(2, "static", monkeypatch)
    card = _card_inputs(_port_inputs(2, host, calls))
    for m in ("density", "force"):
        with pytest.raises(RuntimeError, match="lanes=2"):
            _sweep(cuda_legacy, card, m, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("boundary_mode", ["static", "per_step"])
def test_graph_path_equals_eager_on_cuda(boundary_mode):
    """``WCSPHLegacy`` on the card replays one graph a step (the rebuild,
    a density and a force launch each, and under ``per_step`` a bvol
    launch), bitwise ``graphs=False`` over 30 steps: demo_2d, and the 3D
    dam break (a boundary block) with per-step volumes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured on the card only")
    per_step = boundary_mode == "per_step"
    scene = pt.scene_from_dict(DAM_3D) if per_step else pt.load_scene("scenes/demo_2d.json")
    start = pt.build_state(scene, device="cuda")
    counters = (cuda_legacy.legacy_density_sweep, cuda_legacy.legacy_force_sweep,
                cuda_bounds.sort_and_bound, cuda_sweeps.bvol_sweep)
    out = []
    for graphs in (True, False):
        solver = pt.WCSPHLegacy(scene, device="cuda", graphs=graphs,
                                boundary_mode=boundary_mode)
        assert solver.graphs == graphs
        bound = solver.bind(start)
        before = [c.launches for c in counters]
        out.append(solver.rollout(bound, 30))
        torch.cuda.synchronize()
        after = [c.launches for c in counters]
        assert [a - b for a, b in zip(after, before)] == [30, 30, 30, 30 if per_step else 0]
    assert solver._runner is None
    for k in state_fields(out[0]):
        assert torch.equal(getattr(out[0], k), getattr(out[1], k)), k
