"""The legacy (V1) step's fused row ops: ``legacy_pos_pack``,
``legacy_eos_pack`` and ``legacy_advance`` (``ops/cuda/legacy_rows.py``),
which launch ``csrc/legacy_rows.cu`` on the card and run their plain
versions ``ops.neighbors.legacy_pos``, ``ops.forces.legacy_eos_pack_plain``
and ``legacy_advance_plain`` on the CPU.

- On a CPU tensor the dispatchers return the plain versions' outputs
  bitwise and count no launch; on the card each launch counts as
  ``launches.<wrapper>`` in ``utils.profiling``'s registry.
- The plain versions against ``tisph_tpu``'s legacy step
  (``tisph_tpu/models/wcsph_legacy.py``): the fluid mask of the pos pack
  (:51), the density kept on fluid rows, ``tait_pressure`` and the force
  sum's ``p_rho2`` and ``bound`` (:60-76), ``F.advect`` and
  ``_enforce_boundary_v1`` (:98-122).
- Rows with NaN and infinite fields, and fluid rows outside the box on
  each face: clamped onto the face with that velocity component
  reflected, or left outside under ``reference_exact``.

Inputs from ``np.random.default_rng(seed)`` in 2D and 3D, with
``reference_exact`` on and off and exponents 7 and 2.5: fluid, boundary
and inactive rows.  Elementwise bound rtol 1e-6, as
``tests/test_torch_pointwise_fused.py`` states it (XLA and PyTorch may
round a power differently in the last bit; a pressure whose ratio^gamma -
1 cancels takes an absolute 1e-6 of B).

Marked ``cuda`` (skipped here): each kernel bitwise its plain version on
the same inputs and on a copy with NaN and infinite rows, one launch
each; ``WCSPHLegacy`` 20 steps on the graph path bitwise the eager loop,
each wrapper one launch a step on both.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tisph_tpu.config import SolverParams as JSolverParams
from tisph_tpu.models.state import SimState as JSimState
from tisph_tpu.models.wcsph_legacy import WCSPHLegacy as JWCSPHLegacy
from tisph_tpu.ops import eos as jeos
from tisph_tpu.ops import forces as jF

import tisph_tpu_torch as pt
from tisph_tpu_torch.models.state import MATERIAL_BOUNDARY, MATERIAL_FLUID, MATERIAL_INVALID
from tisph_tpu_torch.ops import forces as F
from tisph_tpu_torch.ops import neighbors
from tisph_tpu_torch.ops.cuda import legacy_rows
from tisph_tpu_torch.ops.grid import state_fields
from tisph_tpu_torch.utils import profiling
from test_torch_legacy_sweeps import DAM_3D

torch.set_num_threads(2)

RTOL = 1e-6
N = 4096
CASES = [(dim, exact, gamma) for dim in (2, 3) for exact in (False, True) for gamma in (7.0, 2.5)]
IDS = [f"{d}d-{'exact' if e else 'reference'}-gamma{g}" for d, e, g in CASES]
FACE_V = np.float32(1e-6)  # dt v far below half an ulp of the box's bounds
WRAPPERS = (legacy_rows.legacy_pos_pack, legacy_rows.legacy_eos_pack, legacy_rows.legacy_advance)
PLAIN = (neighbors.legacy_pos, F.legacy_eos_pack_plain, F.legacy_advance_plain)


def _params(dim, exact=False, gamma=7.0):
    kw = dict(dim=dim, exponent=gamma, reference_exact=exact, support_length=0.1,
              particle_radius=0.025, padding=0.1, domain_start=(0.0,) * dim,
              domain_end=(1.6, 1.0, 0.8)[:dim], gravity=(0.0, -9.81, 0.0)[:dim])
    return pt.SolverParams(**kw), JSolverParams(**kw)


def _inputs(dim, seed, params):
    """Host arrays of one legacy step's row-op inputs: the sorted state's
    fields, the density sum ``acc`` and the force sum ``dv``.  Some fluid
    rows rest on a face of the box, moving outward by less than half an
    ulp of it in a step (they stay there, and x == lo or hi is inside);
    some lie beyond one face only, by 0.05 (they are clamped onto it)."""
    rng = np.random.default_rng(seed)
    mat = rng.choice([MATERIAL_FLUID, MATERIAL_BOUNDARY, MATERIAL_INVALID], N,
                     p=[0.7, 0.2, 0.1]).astype(np.int32)
    lo, hi = (np.asarray(b, np.float32) for b in F.box_bounds(params))
    x = rng.uniform(lo - 0.08, hi + 0.08, (N, dim)).astype(np.float32)
    v = rng.normal(0.0, 2.0, (N, dim)).astype(np.float32)
    dv = rng.normal(0.0, 50.0, (N, dim)).astype(np.float32)
    fluid_rows = np.flatnonzero(mat == MATERIAL_FLUID)
    mid = ((lo + hi) / 2).astype(np.float32)
    for a in range(dim):
        on_lo, on_hi, past_lo, past_hi = fluid_rows[16 * a:16 * a + 16].reshape(4, 4)
        x[on_lo, a], x[on_hi, a] = lo[a], hi[a]
        v[on_lo, a], v[on_hi, a] = -FACE_V, FACE_V
        dv[on_lo, a] = dv[on_hi, a] = 0.0
        past = np.concatenate([past_lo, past_hi])
        x[past] = mid
        x[past_lo, a], x[past_hi, a] = lo[a] - 0.05, hi[a] + 0.05
        dv[past] = 0.0
    return {
        "x": x, "v": v, "dv": dv, "material": mat,
        "mass": rng.uniform(0.005, 0.02, N).astype(np.float32),
        "density": rng.uniform(950.0, 1100.0, N).astype(np.float32),
        "pressure": rng.uniform(0.0, 10.0, N).astype(np.float32),
        "volume": rng.uniform(1e-5, 2e-5, N).astype(np.float32),
        "acc": rng.uniform(900.0, 1200.0, N).astype(np.float32),
        "color": np.zeros((N, 3), np.float32), "object_id": np.zeros(N, np.int32),
    }


def _with_nan_rows(h):
    """A copy of ``h`` with NaN and infinite entries in some rows of every
    float input: the density sum, the stored density (on boundary rows,
    which keep it), the volume, v, x and dv."""
    h = {k: a.copy() for k, a in h.items()}
    rows = np.flatnonzero(h["material"] == MATERIAL_FLUID)[200:208]
    bd = np.flatnonzero(h["material"] == MATERIAL_BOUNDARY)[:3]
    h["acc"][rows[:2]] = np.nan
    h["acc"][rows[2]] = np.inf
    h["density"][bd[:2]] = np.nan
    h["volume"][bd[2]] = np.inf
    h["v"][rows[3], 0] = np.nan
    h["x"][rows[4], -1] = np.nan
    h["x"][rows[5], 0] = -np.inf
    h["dv"][rows[6]] = np.nan
    h["dv"][rows[7], 0] = np.inf
    return h


_FIELDS = ("x", "v", "density", "pressure", "mass", "volume", "material", "color", "object_id")


def _port_state(h, device="cpu"):
    return pt.SimState(**{k: torch.tensor(h[k], device=device) for k in _FIELDS}, num_active=N)


def _jax_state(h):
    return JSimState(**{k: jnp.asarray(h[k]) for k in _FIELDS}, num_active=jnp.int32(N))


def _row_ops(fns, h, params, device="cpu"):
    """pos, (rho, pressure, vel, aux) and the advanced state of ``h``
    through ``fns`` (WRAPPERS or PLAIN), and the state they started
    from."""
    st = _port_state(h, device)
    acc, dv = (torch.tensor(h[k], device=device) for k in ("acc", "dv"))
    pos, eos, adv = fns
    packs = eos(acc, st, params)
    return pos(st), packs, adv(st, packs[0], packs[1], dv, params), st


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(got, want):
    pos, eos, st, _ = got
    w_pos, w_eos, w_st, _ = want
    for name, g, w in zip(("pos", "rho", "pressure", "vel", "aux", "x", "v"),
                          (pos, *eos, st.x, st.v), (w_pos, *w_eos, w_st.x, w_st.v)):
        assert torch.equal(_bits(g), _bits(w)), name


def _launches():
    c = profiling.counters()
    return [c.get(f"launches.{w.__name__}", 0) for w in WRAPPERS]


def _jax_row_ops(h, jparams):
    """``tisph_tpu``'s legacy step on ``h`` between and after its sums:
    the fluid mask, rho, p, p / rho^2, the boundary mask and the advanced
    state."""
    js = _jax_state(h)
    fluid = (js.material == MATERIAL_FLUID).astype(jnp.float32)
    density = jnp.where(js.fluid_mask, jnp.asarray(h["acc"]), js.density)
    rho, p = jeos.tait_pressure(density, jparams.density0, jparams.stiffness, jparams.exponent)
    bound = (~js.fluid_mask & js.active_mask).astype(jnp.float32)
    js = jF.advect(dataclasses.replace(js, density=rho, pressure=p), jnp.asarray(h["dv"]),
                   jparams)
    if not jparams.reference_exact:
        js = JWCSPHLegacy._enforce_boundary_v1(types.SimpleNamespace(params=jparams), js)
    return {"fluid": fluid, "rho": rho, "pressure": p, "p_rho2": p / (rho * rho),
            "bound": bound, "x": js.x, "v": js.v}


def _against_tisph_tpu(h, params, jparams):
    pos, (rho, p, vel, aux), out, st = _row_ops(PLAIN, h, params)
    want = {k: np.asarray(a) for k, a in _jax_row_ops(h, jparams).items()}
    dim = params.dim
    assert torch.equal(pos[:, 3], torch.tensor(want["fluid"]))
    assert torch.equal(aux[:, 2], torch.tensor(want["bound"]))
    np.testing.assert_allclose(rho.numpy(), want["rho"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(vel[:, 3].numpy(), want["rho"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(p.numpy(), want["pressure"], rtol=RTOL,
                               atol=RTOL * params.stiffness)
    np.testing.assert_allclose(aux[:, 0].numpy(), want["p_rho2"], rtol=RTOL,
                               atol=RTOL * params.stiffness / params.density0**2)
    for k in ("x", "v"):
        np.testing.assert_allclose(getattr(out, k).numpy(), want[k], rtol=RTOL, atol=0,
                                   err_msg=k)
    # the copied columns are exact, NaNs included
    for got, want in ((pos[:, :dim], h["x"]), (vel[:, :dim], h["v"]), (aux[:, 1], h["volume"]),
                      (pos[:, dim:3], np.zeros((N, 3 - dim), np.float32)),
                      (vel[:, dim:3], np.zeros((N, 3 - dim), np.float32)),
                      (aux[:, 3], np.zeros(N, np.float32))):
        assert torch.equal(_bits(got), _bits(torch.tensor(want)))
    assert out.density is rho and out.pressure is p
    return out, st


@pytest.mark.parametrize("dim", [2, 3])
def test_dispatchers_on_cpu_are_the_plain_versions(dim):
    params, _ = _params(dim)
    h = _inputs(dim, 100 + dim, params)
    before = profiling.launch_counters()
    got = _row_ops(WRAPPERS, h, params)
    assert profiling.launch_counters() == before
    _same_bits(got, _row_ops(PLAIN, h, params))


@pytest.mark.parametrize("dim,exact,gamma", CASES, ids=IDS)
def test_plain_row_ops_match_tisph_tpu(dim, exact, gamma):
    params, jparams = _params(dim, exact, gamma)
    h = _inputs(dim, 10 * dim + 2 * exact + int(gamma), params)
    out, st = _against_tisph_tpu(h, params, jparams)
    # rows off the fluid family pass through bitwise; their density is
    # the stored one, clamped, never the sum
    other = torch.tensor(h["material"] != MATERIAL_FLUID)
    assert torch.equal(_bits(out.x[other]), _bits(st.x[other]))
    assert torch.equal(_bits(out.v[other]), _bits(st.v[other]))
    stored = np.maximum(h["density"], params.density0)
    np.testing.assert_array_equal(out.density.numpy()[other.numpy()], stored[other.numpy()])


@pytest.mark.parametrize("dim,exact", [(d, e) for d in (2, 3) for e in (False, True)],
                         ids=[f"{d}d-{'exact' if e else 'reference'}" for d in (2, 3)
                              for e in (False, True)])
def test_rows_on_and_past_each_face(dim, exact):
    """A fluid row past one face is clamped onto it and that velocity
    component alone becomes -c_f v (v - (1 + c_f) v); a row resting on a
    face stays there with its velocity, outward as it is (x == lo or hi
    is not outside).  Under ``reference_exact`` no row is clamped."""
    params, jparams = _params(dim, exact)
    h = _inputs(dim, 50 + dim, params)
    out, _ = _against_tisph_tpu(h, params, jparams)
    lo, hi = F.box_bounds(params)
    cf1 = np.float32(1.0 + params.collision_factor)
    fluid_rows = np.flatnonzero(h["material"] == MATERIAL_FLUID)
    x, v = out.x.numpy(), out.v.numpy()
    for a in range(dim):
        on_lo, on_hi, past_lo, past_hi = fluid_rows[16 * a:16 * a + 16].reshape(4, 4)
        assert (x[on_lo, a] == np.float32(lo[a])).all() and (x[on_hi, a] == np.float32(hi[a])).all()
        assert (v[on_lo, a] == -FACE_V).all() and (v[on_hi, a] == FACE_V).all()
        for rows, face, sign in ((past_lo, lo[a], -1.0), (past_hi, hi[a], 1.0)):
            v_in = h["v"][rows]  # dv is 0 on these rows
            if exact:
                assert (sign * (x[rows, a] - np.float32(face)) > 0.04).all()
                np.testing.assert_array_equal(v[rows], v_in)
            else:
                assert (x[rows, a] == np.float32(face)).all()
                np.testing.assert_array_equal(v[rows, a], v_in[:, a] - cf1 * v_in[:, a])
                rest = [b for b in range(dim) if b != a]
                np.testing.assert_array_equal(v[rows][:, rest], v_in[:, rest])


@pytest.mark.parametrize("dim", [2, 3])
def test_nan_and_infinite_rows_match_tisph_tpu(dim):
    """NaN and infinite inputs give the same NaN and infinite outputs as
    ``tisph_tpu``: a NaN passes the clamps, a comparison with it is
    false, an infinite coordinate lands on its face."""
    params, jparams = _params(dim)
    h = _with_nan_rows(_inputs(dim, 60 + dim, params))
    out, _ = _against_tisph_tpu(h, params, jparams)
    rows = np.flatnonzero(h["material"] == MATERIAL_FLUID)[200:208]
    assert np.isnan(out.density.numpy()[rows[:2]]).all()
    assert np.isinf(out.pressure.numpy()[rows[2]])
    assert np.isnan(out.x.numpy()[rows[4], -1])
    assert out.x.numpy()[rows[5], 0] == np.float32(F.box_bounds(params)[0][0])
    assert np.isnan(out.v.numpy()[rows[6]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dim,exact,gamma", CASES, ids=IDS)
def test_kernels_match_plain_on_cuda(dim, exact, gamma):
    """Each kernel bitwise its plain version on the card, NaN rows too,
    one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/legacy_rows.cu runs on the card only")
    params, _ = _params(dim, exact, gamma)
    base = _inputs(dim, 70 + 10 * dim + 2 * exact + int(gamma), params)
    for h in (base, _with_nan_rows(base)):
        before = _launches()
        got = _row_ops(WRAPPERS, h, params, device="cuda")
        assert [a - b for a, b in zip(_launches(), before)] == [1, 1, 1]
        _same_bits(got, _row_ops(PLAIN, h, params, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("boundary_mode", ["static", "per_step"])
def test_graph_rollout_equals_eager_on_cuda(boundary_mode):
    """``WCSPHLegacy`` 20 steps on the graph path bitwise the eager loop in
    every field, each row-op wrapper one launch a step on both: demo_2d,
    and the 3D dam break (a boundary block) with per-step volumes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured on the card only")
    per_step = boundary_mode == "per_step"
    scene = pt.scene_from_dict(DAM_3D) if per_step else pt.load_scene("scenes/demo_2d.json")
    start = pt.build_state(scene, device="cuda")
    out = []
    for use_graphs in (True, False):
        solver = pt.WCSPHLegacy(scene, device="cuda", graphs=use_graphs,
                                boundary_mode=boundary_mode)
        assert solver.graphs == use_graphs
        bound = solver.bind(start)
        before = _launches()
        out.append(solver.rollout(bound, 20))
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_launches(), before)] == [20, 20, 20]
    for k in state_fields(out[0]):
        assert torch.equal(getattr(out[0], k), getattr(out[1], k)), k
