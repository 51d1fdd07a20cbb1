"""Port pointwise math: the analytic cubic-spline cases of test_kernels.py,
then W, grad W, the Tait EOS, advect and the domain clamp elementwise
against tisph_tpu on numpy-random input.

Elementwise bound rtol 1e-6: the ops run in the same order in f32, but
XLA and PyTorch may round an integer power (x^7 by square-and-multiply),
a fused multiply-add or a 3-term sum differently in the last bit.  grad W
adds an absolute 1e-6 of its largest value: its factor (3q - 2) cancels
near q = 2/3, where a 1-ulp difference in r^2 is a larger relative error
on a near-zero component."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tisph_tpu as tt
from tisph_tpu.models.state import state_to_host as jax_to_host
from tisph_tpu.ops import eos as jeos
from tisph_tpu.ops import forces as jF
from tisph_tpu.ops import kernels as jk

import tisph_tpu_torch as pt
from tisph_tpu_torch.ops import eos, forces as F
from tisph_tpu_torch.ops.kernels import cubic_kernel, cubic_kernel_grad, cubic_kernel_sigma

from test_golden import SCENE_2D, SCENE_3D

torch.set_num_threads(2)

RTOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# -- analytic cases (tests/test_kernels.py) --------------------------------

@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_normalizes_to_one(dim):
    h, n = 0.13, 161
    xs = np.linspace(-h, h, n)
    grids = np.meshgrid(*([xs] * dim), indexing="ij")
    r = np.sqrt(sum(g**2 for g in grids))
    w = cubic_kernel(_t(r.ravel()), h, dim).numpy()
    assert abs(w.sum() * (xs[1] - xs[0]) ** dim - 1.0) < 2e-2


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_compact_support(dim):
    h = 0.04
    assert np.allclose(cubic_kernel(_t([h, 1.5 * h, 100.0]), h, dim).numpy(), 0.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_continuity_and_decrease(dim):
    lo = float(cubic_kernel(_t(0.5 - 1e-6), 1.0, dim))
    hi = float(cubic_kernel(_t(0.5 + 1e-6), 1.0, dim))
    assert abs(lo - hi) < 1e-4
    w = cubic_kernel(torch.linspace(0.0, 0.04 * 0.999, 100), 0.04, dim).numpy()
    assert (w > 0).all() and (np.diff(w) <= 1e-9).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_gradient_matches_finite_difference_and_is_odd(dim):
    h = 0.04
    rng = np.random.default_rng(0)
    pts = rng.uniform(-h, h, size=(64, dim)).astype(np.float32)
    pts = pts[np.linalg.norm(pts, axis=1) > 0.05 * h]
    g = cubic_kernel_grad(_t(pts), h, dim).numpy()
    eps = 1e-4 * h
    for axis in range(dim):
        e = np.zeros(dim, np.float32)
        e[axis] = eps
        wp = cubic_kernel(torch.linalg.norm(_t(pts + e), dim=1), h, dim).numpy()
        wm = cubic_kernel(torch.linalg.norm(_t(pts - e), dim=1), h, dim).numpy()
        fd = (wp - wm) / (2 * eps)
        scale = np.abs(g[:, axis]).max() + 1e-3
        np.testing.assert_allclose(g[:, axis] / scale, fd / scale, atol=5e-3)
    np.testing.assert_allclose(cubic_kernel_grad(_t(-pts), h, dim).numpy(), -g, atol=1e-6)
    zero = cubic_kernel_grad(_t([[0.0] * dim, [h] * dim, [2 * h] + [0.0] * (dim - 1)]), h, dim)
    assert np.allclose(zero.numpy(), 0.0)


def test_eos_analytic():
    rho, p = eos.tait_pressure(_t([900.0, 1000.0, 1100.0]), 1000.0, 50.0, 7.0)
    assert float(rho[0]) == 1000.0 and float(p[0]) == 0.0 and abs(float(p[1])) < 1e-6
    np.testing.assert_allclose(float(p[2]), 50.0 * (1.1**7 - 1.0), rtol=1e-5)


# -- elementwise against tisph_tpu -----------------------------------------

@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_and_grad_match_jax(dim):
    h = 0.04
    rng = np.random.default_rng(10 + dim)
    r = rng.uniform(0.0, 1.2 * h, 4096).astype(np.float32)
    vec = rng.uniform(-h, h, (4096, dim)).astype(np.float32)
    assert cubic_kernel_sigma(dim, h) == jk.cubic_kernel_sigma(dim, h)
    np.testing.assert_allclose(cubic_kernel(_t(r), h, dim).numpy(),
                               np.asarray(jk.cubic_kernel(jnp.asarray(r), h, dim)), rtol=RTOL)
    want = np.asarray(jk.cubic_kernel_grad(jnp.asarray(vec), h, dim))
    np.testing.assert_allclose(cubic_kernel_grad(_t(vec), h, dim).numpy(), want,
                               rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("exponent", [7.0, 3.0, 1.0])
def test_tait_matches_jax(exponent):
    rho = np.random.default_rng(1).uniform(800.0, 1300.0, 4096).astype(np.float32)
    got = eos.tait_pressure(_t(rho), 1000.0, 50.0, exponent)
    want = jeos.tait_pressure(jnp.asarray(rho), 1000.0, 50.0, exponent)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def _random_states(raw, seed):
    """The same state in both packages, with numpy-random velocities,
    positions pushed past the clamp box on some rows, and inactive slots."""
    ref = tt.build_state(tt.scene_from_dict(raw))
    host = jax_to_host(ref)
    rng = np.random.default_rng(seed)
    n, dim = host["x"].shape
    lo, hi = np.asarray(raw["configuration"]["domainStart"]), np.asarray(
        raw["configuration"]["domainEnd"])
    host["x"] = rng.uniform(lo - 0.05, hi + 0.05, (n, dim)).astype(np.float32)
    host["v"] = rng.normal(0.0, 2.0, (n, dim)).astype(np.float32)
    ref = dataclasses.replace(ref, x=jnp.asarray(np.pad(host["x"], ((0, ref.capacity - n), (0, 0)))),
                              v=jnp.asarray(np.pad(host["v"], ((0, ref.capacity - n), (0, 0)))))
    port = pt.build_state(pt.scene_from_dict(raw), device="cpu")
    port = dataclasses.replace(port, x=torch.tensor(np.asarray(ref.x)),
                               v=torch.tensor(np.asarray(ref.v)))
    dv = rng.normal(0.0, 50.0, (ref.capacity, dim)).astype(np.float32)
    return ref, port, dv


@pytest.mark.parametrize("raw", [SCENE_2D, SCENE_3D], ids=["2d", "3d"])
def test_advect_and_clamp_match_jax(raw):
    ref, port, dv = _random_states(raw, seed=len(raw["configuration"]["domainEnd"]))
    params = pt.SolverParams.from_scene(pt.scene_from_dict(raw))
    jparams = tt.SolverParams.from_scene(tt.scene_from_dict(raw))
    want = jF.enforce_domain_boundary(jF.advect(ref, jnp.asarray(dv), jparams), jparams)
    got = F.enforce_domain_boundary(F.advect(port, torch.as_tensor(dv), params), params)
    for k in ("x", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=RTOL, atol=0, err_msg=k)
    # some rows really were clamped onto the box
    lo, hi = F.domain_box(params, port.device)
    assert ((got.x == lo) | (got.x == hi)).any()


@pytest.mark.parametrize("compat", ["reference", "reference-exact"])
def test_pressures_and_density_mode_match_jax(compat):
    ref, port, _ = _random_states(SCENE_2D, seed=3)
    params = pt.SolverParams.from_scene(pt.scene_from_dict(SCENE_2D), compat)
    jparams = tt.SolverParams.from_scene(tt.scene_from_dict(SCENE_2D), compat)
    rho = np.random.default_rng(4).uniform(900.0, 1200.0, ref.capacity).astype(np.float32)
    want = jF.compute_pressures(jF.apply_density_mode(jnp.asarray(rho), ref, jparams), jparams)
    got = F.compute_pressures(F.apply_density_mode(_t(rho), port, params), params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
