"""The substep's fused row ops: ``eos_packs`` and ``advance``
(``tisph_tpu_torch/models/wcsph.py``), which launch ``csrc/pointwise.cu``
on the card (``ops/cuda/pointwise.py``) and run their plain versions
``ops.forces.eos_packs_plain`` and ``advance_plain`` on the CPU.

- On a CPU tensor the dispatchers return the plain versions' outputs
  bitwise and count no launch.
- The plain ``eos_packs`` against ``tisph_tpu``'s row ops
  (``tisph_tpu/models/wcsph.py:255-264``): the density kept on the
  sort-time fluid rows, ``F.apply_density_mode``, ``F.compute_pressures``
  and ``ps.repack_eos``'s ``_RHO``, ``_P`` and ``_PRHO2`` rows.
- The plain ``advance`` against ``jF.advect`` with
  ``jF.enforce_domain_boundary``, the per-axis arithmetic of
  ``tisph_tpu/models/wcsph.py:283-311``.

Inputs from ``np.random.default_rng(seed)`` in 2D and 3D, with
``reference_exact`` on and off and exponents 7 and 2.5: fluid, boundary
and inactive rows, rows that are fluid now but not at sort time (an
emitter's batch inside a group), and rows resting on the box's ``lo`` and
``hi`` faces.  Elementwise bound rtol 1e-6, as
``tests/test_torch_pointwise.py`` states it: the ops run in the same
order in f32, but XLA and PyTorch may round a power or a 3-term sum
differently in the last bit.  A pressure whose ratio^gamma - 1 cancels
also takes an absolute 1e-6 of B (rtol 1e-6 on ratio^gamma).

Marked ``cuda`` (skipped here): each kernel against its plain version on
the same inputs plus NaN and infinite rows, bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tisph_tpu.config import SolverParams as JSolverParams
from tisph_tpu.models.state import SimState as JSimState
from tisph_tpu.ops import forces as jF
from tisph_tpu.ops.pallas import sweeps as ps

import tisph_tpu_torch as pt
from tisph_tpu_torch.models import wcsph
from tisph_tpu_torch.models.state import MATERIAL_BOUNDARY, MATERIAL_FLUID, MATERIAL_INVALID
from tisph_tpu_torch.ops import forces as F
from tisph_tpu_torch.utils import profiling

torch.set_num_threads(2)

RTOL = 1e-6
N = 4096
CASES = [(dim, exact, gamma) for dim in (2, 3) for exact in (False, True) for gamma in (7.0, 2.5)]
IDS = [f"{d}d-{'exact' if e else 'reference'}-gamma{g}" for d, e, g in CASES]


def _params(dim, exact=False, gamma=7.0):
    kw = dict(dim=dim, exponent=gamma, reference_exact=exact, support_length=0.1,
              particle_radius=0.025, padding=0.1, domain_start=(0.0,) * dim,
              domain_end=(1.6, 1.0, 0.8)[:dim], gravity=(0.0, -9.81, 0.0)[:dim])
    return pt.SolverParams(**kw), JSolverParams(**kw)


def _inputs(dim, seed, params):
    """Host arrays of one substep's row-op inputs: the state's fields, the
    sort-time fluid mask, the density sweep's rho, flm and dv."""
    rng = np.random.default_rng(seed)
    mat = rng.choice([MATERIAL_FLUID, MATERIAL_BOUNDARY, MATERIAL_INVALID], N,
                     p=[0.7, 0.2, 0.1]).astype(np.int32)
    lo, hi = (np.asarray(b, np.float32) for b in F.box_bounds(params))
    x = rng.uniform(lo - 0.08, hi + 0.08, (N, dim)).astype(np.float32)
    v = rng.normal(0.0, 2.0, (N, dim)).astype(np.float32)
    dv = rng.normal(0.0, 50.0, (N, dim)).astype(np.float32)
    fluid_rows = np.flatnonzero(mat == MATERIAL_FLUID)
    # fluid rows resting on a face, axis by axis: x stays there exactly
    for k, a in enumerate(range(dim)):
        on_lo, on_hi = fluid_rows[8 * k:8 * k + 4], fluid_rows[8 * k + 4:8 * k + 8]
        x[on_lo, a], x[on_hi, a] = lo[a], hi[a]
        v[on_lo, a] = v[on_hi, a] = dv[on_lo, a] = dv[on_hi, a] = 0.0
    mass = rng.uniform(0.005, 0.02, N).astype(np.float32)
    fluid_now = mat == MATERIAL_FLUID
    fluid_sort = fluid_now.copy()
    fluid_sort[fluid_rows[-16:]] = False  # emitted after the group's rebuild
    return {
        "x": x, "v": v, "dv": dv, "material": mat, "mass": mass,
        "density": rng.uniform(950.0, 1100.0, N).astype(np.float32),
        "pressure": rng.uniform(0.0, 10.0, N).astype(np.float32),
        "volume": rng.uniform(1e-5, 2e-5, N).astype(np.float32),
        "rho": rng.uniform(900.0, 1200.0, N).astype(np.float32),
        "fluid": fluid_sort, "flm": (fluid_sort * mass).astype(np.float32),
        "color": np.zeros((N, 3), np.float32), "object_id": np.zeros(N, np.int32),
    }


def _fields(h):
    return {k: h[k] for k in ("x", "v", "density", "pressure", "mass", "volume", "material",
                              "color", "object_id")}


def _port_state(h, device="cpu"):
    return pt.SimState(**{k: torch.tensor(a, device=device) for k, a in _fields(h).items()},
                       num_active=N)


def _jax_state(h):
    return JSimState(**{k: jnp.asarray(a) for k, a in _fields(h).items()},
                     num_active=jnp.int32(N))


def _row_ops(h, params, device="cpu"):
    """The port's eos_packs then advance on ``h`` (through ``wcsph``'s
    dispatchers), and the arguments they took."""
    st = _port_state(h, device)
    t = {k: torch.tensor(h[k], device=device) for k in ("rho", "fluid", "flm", "dv")}
    eos = wcsph.eos_packs(t["rho"], st, t["fluid"], t["flm"], params)
    out = wcsph.advance(st, eos[0], eos[1], t["dv"], params)
    return eos, out, st, t


def _launches():
    """The kernels' launch counters: (eos_pack, advance)."""
    c = profiling.counters()
    return c.get("launches.eos_pack", 0), c.get("launches.advance", 0)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dim", [2, 3])
def test_dispatchers_on_cpu_are_the_plain_versions(dim):
    params, _ = _params(dim)
    h = _inputs(dim, 100 + dim, params)
    before = profiling.launch_counters()
    eos, out, st, t = _row_ops(h, params)
    assert profiling.launch_counters() == before
    want = F.eos_packs_plain(t["rho"], st, t["fluid"], t["flm"], params)
    for g, w in zip(eos, want):
        assert torch.equal(_bits(g), _bits(w))
    want = F.advance_plain(st, want[0], want[1], t["dv"], params)
    for k in ("x", "v", "density", "pressure", "material", "mass"):
        assert torch.equal(_bits(getattr(out, k)), _bits(getattr(want, k))), k


@pytest.mark.parametrize("dim,exact,gamma", CASES, ids=IDS)
def test_eos_packs_match_tisph_tpu(dim, exact, gamma):
    params, jparams = _params(dim, exact, gamma)
    h = _inputs(dim, 10 * dim + 2 * exact + int(gamma), params)
    (rho, p, vel, aux), _, _, _ = _row_ops(h, params)

    js = _jax_state(h)
    keep = jnp.asarray(h["fluid"])
    j_rho = jnp.where(keep, jnp.asarray(h["rho"]), js.density)
    j_rho = jF.apply_density_mode(j_rho, js, jparams)
    j_rho, j_p = jF.compute_pressures(j_rho, jparams)
    pack = np.asarray(ps.repack_eos(jnp.zeros((16, N), jnp.float32), j_rho, j_p))

    np.testing.assert_allclose(rho.numpy(), pack[ps._RHO], rtol=RTOL, atol=0)
    np.testing.assert_allclose(vel[:, 3].numpy(), pack[ps._RHO], rtol=RTOL, atol=0)
    # the pressure's ratio^gamma - 1 cancels near rho0: rtol 1e-6 of ratio^gamma
    np.testing.assert_allclose(p.numpy(), pack[ps._P], rtol=RTOL, atol=RTOL * params.stiffness)
    np.testing.assert_allclose(aux[:, 0].numpy(), pack[ps._PRHO2], rtol=RTOL,
                               atol=RTOL * params.stiffness / params.density0**2)
    # the copied columns are exact
    assert torch.equal(vel[:, :dim], torch.tensor(h["v"]))
    assert torch.equal(vel[:, dim:3], torch.zeros(N, 3 - dim))
    assert torch.equal(aux[:, 1:], torch.stack([torch.tensor(h["flm"]), torch.tensor(h["mass"]),
                                                torch.zeros(N)], dim=1))
    # the emitted rows keep their stored density (or take m W(0)), the
    # boundary rows theirs: clamped, never the sweep's sum
    fl_now = h["material"] == MATERIAL_FLUID
    emitted = fl_now & ~h["fluid"]
    stored = np.maximum(h["density"], params.density0)
    if exact:
        assert (rho.numpy()[fl_now] == np.float32(params.density0)).all()
        assert (p.numpy()[fl_now] == 0.0).all()
    else:
        np.testing.assert_array_equal(rho.numpy()[emitted], stored[emitted])
    np.testing.assert_array_equal(rho.numpy()[~fl_now], stored[~fl_now])


@pytest.mark.parametrize("dim", [2, 3])
def test_advance_matches_tisph_tpu(dim):
    params, jparams = _params(dim)
    h = _inputs(dim, 40 + dim, params)
    (rho, p, _, _), out, st, _ = _row_ops(h, params)

    want = jF.enforce_domain_boundary(jF.advect(_jax_state(h), jnp.asarray(h["dv"]), jparams),
                                      jparams)
    for k in ("x", "v"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=RTOL, atol=0, err_msg=k)
    assert out.density is rho and out.pressure is p
    # boundary and inactive rows pass through bitwise
    other = torch.tensor(h["material"] != MATERIAL_FLUID)
    assert torch.equal(_bits(out.x[other]), _bits(st.x[other]))
    assert torch.equal(_bits(out.v[other]), _bits(st.v[other]))
    # the face rows: x stays on lo and on hi; x <= lo reflects the velocity
    # (here 0 on that axis), x == hi does not count as outside
    lo, hi = F.box_bounds(params)
    fluid_rows = np.flatnonzero(h["material"] == MATERIAL_FLUID)
    for a in range(dim):
        on_lo, on_hi = fluid_rows[8 * a:8 * a + 4], fluid_rows[8 * a + 4:8 * a + 8]
        assert (out.x[on_lo, a] == lo[a]).all() and (out.x[on_hi, a] == hi[a]).all()
    # and some rows really were clamped from outside the box
    outside = torch.tensor((h["x"] < np.asarray(lo) - 0.01).any(1) & (h["material"] == MATERIAL_FLUID))
    assert outside.any() and (out.x[outside] >= torch.tensor(lo)).all()


def _with_nan_rows(h):
    """A copy of ``h`` with NaN and infinite rows in every float input."""
    h = {k: a.copy() for k, a in h.items()}
    rows = np.flatnonzero(h["material"] == MATERIAL_FLUID)[40:48]
    bd = np.flatnonzero(h["material"] == MATERIAL_BOUNDARY)[:2]
    h["rho"][rows[:2]] = np.nan
    h["rho"][rows[2]] = np.inf
    h["density"][bd] = np.nan
    h["v"][rows[3], 0] = np.nan
    h["x"][rows[4], -1] = np.nan
    h["dv"][rows[5]] = np.nan
    h["dv"][rows[6], 0] = np.inf
    h["mass"][rows[7]] = np.nan
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("dim,exact,gamma", CASES, ids=IDS)
def test_kernels_match_plain_on_cuda(dim, exact, gamma):
    """Each kernel bitwise its plain version on the card, NaN rows too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/pointwise.cu runs on the card only")
    params, _ = _params(dim, exact, gamma)
    base = _inputs(dim, 70 + 10 * dim + 2 * exact + int(gamma), params)
    for h in (base, _with_nan_rows(base)):
        before = _launches()
        eos, out, st, t = _row_ops(h, params, device="cuda")
        assert _launches() == (before[0] + 1, before[1] + 1)
        want = F.eos_packs_plain(t["rho"], st, t["fluid"], t["flm"], params)
        for name, g, w in zip(("rho", "pressure", "vel", "aux"), eos, want):
            assert torch.equal(_bits(g), _bits(w)), name
        want = F.advance_plain(st, eos[0], eos[1], t["dv"], params)
        for k in ("x", "v"):
            assert torch.equal(_bits(getattr(out, k)), _bits(getattr(want, k))), k
