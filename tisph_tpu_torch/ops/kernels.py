"""SPH cubic-spline smoothing kernel: normalisation, W and grad W.

The piecewise reference form (sph_base.py:18-60 of the reference), as in
``tisph_tpu.ops.kernels``.  The neighbour sweeps do not call these: they
use the branch-free spline of ``tisph_tpu``'s TPU sweep kernel (see
``ops.neighbors``), which agrees with this form to f32 rounding.
"""

from __future__ import annotations

import math

import torch


def cubic_kernel_sigma(dim: int, h: float) -> float:
    """Normalisation factor k / h**dim for the cubic spline."""
    if dim == 1:
        k = 4.0 / 3.0
    elif dim == 2:
        k = 40.0 / (7.0 * math.pi)
    elif dim == 3:
        k = 8.0 / math.pi
    else:
        raise ValueError(f"unsupported dim={dim}")
    return k / h**dim


def cubic_kernel(r_norm: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """W(r) for pair distance(s) ``r_norm``:
    k (6 (q^3 - q^2) + 1) for q <= 0.5, k 2 (1 - q)^3 for q <= 1, else 0."""
    k = cubic_kernel_sigma(dim, h)
    q = r_norm / h
    inner = 6.0 * (q * q * q - q * q) + 1.0
    outer_b = 1.0 - q
    outer = 2.0 * outer_b * outer_b * outer_b
    w = torch.where(q <= 0.5, inner, outer)
    return torch.where(q <= 1.0, k * w, torch.zeros_like(w))


def cubic_kernel_grad(r_vec: torch.Tensor, h: float, dim: int, eps: float = 1e-5) -> torch.Tensor:
    """grad W with respect to x_i for displacement(s) r = x_i - x_j, shape
    (..., dim); zero where |r| <= eps or q > 1."""
    k6 = 6.0 * cubic_kernel_sigma(dim, h)
    r2 = torch.sum(r_vec * r_vec, dim=-1, keepdim=True)
    r_norm = torch.sqrt(r2)
    q = r_norm / h
    inv = 1.0 / torch.clamp(r_norm * h, min=eps * h)
    grad_q = r_vec * inv
    inner = k6 * q * (3.0 * q - 2.0)
    fac = 1.0 - q
    outer = -k6 * fac * fac
    mag = torch.where(q <= 0.5, inner, outer)
    valid = (r_norm > eps) & (q <= 1.0)
    return torch.where(valid, mag * grad_q, torch.zeros_like(grad_q))
