"""Tait equation of state with the reference's density clamp
(wcsphv2.py:44-48): rho <- max(rho, rho0), p = B ((rho/rho0)^gamma - 1)."""

from __future__ import annotations

import torch


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y by square-and-multiply in the order XLA lowers ``integer_pow``,
    so an integer exponent rounds as it does in ``tisph_tpu``."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def integer_exponent(exponent: float) -> int:
    """gamma as the integer in [1, 16] that :func:`tait_pressure` raises to
    by square-and-multiply, else 0 (a float power)."""
    e = float(exponent)
    return int(e) if e == int(e) and 1 <= int(e) <= 16 else 0


def tait_pressure(
    density: torch.Tensor,
    density0: float,
    stiffness: float,
    exponent: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (clamped_density, pressure)."""
    rho = torch.clamp(density, min=density0)
    ratio = rho / density0
    k = integer_exponent(exponent)
    p = _integer_pow(ratio, k) if k else ratio**exponent
    return rho, stiffness * (p - 1.0)
