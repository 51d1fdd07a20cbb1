"""The work of a step, frozen as the physics' work so that a kernel that
later fuses or rewrites a sum does not move it: the card's peaks, the
operations per pair inside h and per row, and the bytes each phase has
to read and write once.

Copied from ``chip_smoke.py`` (lines 432-458) of the program's tree:

- ``HBM_BYTES_PER_S``, ``F32_FLOPS`` (``chip_smoke.py:432-433``): one
  H100 SXM's published HBM rate and float32 rate outside the tensor cores
  (NVIDIA's data sheet), at its 700 W power limit;
- ``FLOPS_PER_PAIR`` (``:442``): float32 operations per pair inside h of
  the V2 sums, counted from ``csrc/sweeps.cu`` (23 to the spline value,
  then density +2, force +37);
- ``LEGACY_FLOPS_PER_PAIR`` (``:448``): the same for the V1 sums, by dim,
  counted from ``csrc/legacy.cu``;
- ``EOS_FLOPS_PER_ROW`` (``:457``): the EOS and the force packs, a row;
- ``ADVANCE_FLOPS_PER_FLUID_ROW`` (``:458``): symplectic Euler and the
  domain clamp, a fluid row, by dim.

The coupled step's (kind ``rigid``, ``tt.WCSPHRigid``), counted from
``csrc/sweeps.cu`` and ``csrc/sweep_common.cuh`` for this file:

- ``bvol``, every step (the bodies move): kernel A's mode 2 on each
  boundary row over its live j, the density's arithmetic
  (``FLOPS_PER_PAIR["density"]``, the pack's w the boundary flag);
- ``force_react`` (mode 3) in place of ``force``: on a fluid row the
  force's 60 operations a pair; on a boundary row
  ``REACTION_FLOPS_PER_PAIR``, 23 to the spline value, then the gradient
  magnitude 4, ``dot_neg`` 11 (three differences, three products, two
  sums, the min, r^2 + eps, the divide), nu_b,j 3 (max, reciprocal,
  product), the coefficient 5 and the three accumulations 6;
- the bodies' passes of ``models/rigid.py`` (``body_sums`` and
  ``move_body_rows``, a pass over all N rows a body): the bytes of the
  fields each reads and writes once, ``BODY_BYTES_PER_ROW`` by dim (x,
  mass, tag, the boundary flag and the reaction read to sum; tag, flag,
  x and v read and x and v written to move).

The pairs are counted by this file's own cell list on the benchmark's
states, never by the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.cells import CellList

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
FLOPS_PER_PAIR = {"density": 25, "force": 60}
LEGACY_FLOPS_PER_PAIR = {"density": {2: 21, 3: 24}, "force": {2: 43, 3: 53}}
EOS_FLOPS_PER_ROW = 12
ADVANCE_FLOPS_PER_FLUID_ROW = {2: 38, 3: 56}
REACTION_FLOPS_PER_PAIR = 52
BODY_BYTES_PER_ROW = {d: (4 * d + 4 + 4 + 1 + 4 * d) + (4 + 1 + 2 * 4 * d + 2 * 4 * d)
                      for d in (2, 3)}


def count_pairs(x: torch.Tensor, material: torch.Tensor, h: float,
                domain_start, domain_end, boundary: bool = False) -> dict[str, int]:
    """Pairs inside h (r < h) of the fluid rows i of a state:
    ``with_self`` over every live j, the self pair included (the V2
    sums); ``fluid`` over fluid j != i (the V1 density); ``live`` over
    live j != i (the V1 force); with ``boundary`` also
    ``boundary_with_self``, of the boundary rows i over every live j, the
    self pair included (the coupled step's bvol and reactions)."""
    live = torch.nonzero(material >= 0).squeeze(1)
    fluid = material[live] == 1
    cl = CellList(x, live, domain_start, domain_end, h)
    counts = torch.zeros(3, dtype=torch.int64, device=x.device)
    for i, j in cl.candidates(fluid):
        d = x[i].to(torch.float64) - x[j].to(torch.float64)
        near = (d * d).sum(-1) < h * h
        other = near & (i != j)
        counts += torch.stack([near.sum(), (other & (material[j] == 1)).sum(), other.sum()])
    with_self, fl, lv = counts.tolist()
    out = {"with_self": with_self, "fluid": fl, "live": lv}
    if boundary:
        near = 0
        for i, j in cl.candidates(material[live] == 0):
            d = x[i].to(torch.float64) - x[j].to(torch.float64)
            near += int(((d * d).sum(-1) < h * h).sum())
        out["boundary_with_self"] = near
    return out


def _phase_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def step_bound_ms(solver: str, dim: int, rows: int, fluid: int, cells: int, resort: int,
                  pairs: dict[str, float], bodies: int = 0) -> dict[str, float]:
    """The least ms of one step's phases on the card, each the larger of
    its bytes (each input read once, each output written once) over the
    HBM rate and its operations over the float32 rate: the density and
    force sums, the rebuild (every ``resort`` steps) and the two row ops;
    for ``rigid`` also ``bvol`` and the ``bodies`` dynamic bodies' passes,
    and ``force_react`` in place of the force.  ``rows`` are the state's
    rows, ``cells`` the grid's, ``pairs`` from :func:`count_pairs` (a mean
    over states; for ``rigid``, with ``boundary``)."""
    words = 2 * dim + 8  # 4-byte words of a row: x, v, density, pressure, mass, volume,
    #                      material, color (3), object_id
    pack = rows * 16  # one float4 pack a row
    index = rows * 4 + (cells + 1) * 4  # sort-time ids and the CSR bounds
    if solver in ("wcsph", "rigid"):
        density_ops = pairs["with_self"] * FLOPS_PER_PAIR["density"]
        force_ops = pairs["with_self"] * FLOPS_PER_PAIR["force"]
    elif solver == "legacy":
        density_ops = pairs["fluid"] * LEGACY_FLOPS_PER_PAIR["density"][dim]
        force_ops = pairs["live"] * LEGACY_FLOPS_PER_PAIR["force"][dim]
    else:
        raise ValueError(f"unknown solver {solver!r}")
    phases = {
        "density": _phase_ms(pack + index + rows * 4 + rows * 4, density_ops),
        "force": _phase_ms(3 * pack + index + rows * 4 + rows * dim * 4, force_ops),
        "rebuild": _phase_ms(2 * rows * 4 * words + (cells + 1) * 4, 0) / resort,
        "eos": _phase_ms(rows * (4 + 1 + 4 + 4 + 4 * dim) + rows * (4 + 4 + 16 + 16),
                         rows * EOS_FLOPS_PER_ROW),
        "advance": _phase_ms(rows * (2 * 4 * dim + 4) + fluid * 4 * dim + rows * 2 * 4 * dim,
                             fluid * ADVANCE_FLOPS_PER_FLUID_ROW[dim]),
    }
    if solver == "rigid":
        boundary_pairs = pairs["boundary_with_self"]
        phases["bvol"] = _phase_ms(pack + index + rows * 4 + rows * 4,
                                   boundary_pairs * FLOPS_PER_PAIR["density"])
        del phases["force"]
        phases["force_react"] = _phase_ms(3 * pack + index + rows * 4 + rows * dim * 4,
                                          force_ops + boundary_pairs * REACTION_FLOPS_PER_PAIR)
        phases["bodies"] = _phase_ms(bodies * rows * BODY_BYTES_PER_ROW[dim], 0)
    return phases


def grid_cells(domain_start, domain_end, h: float) -> int:
    """Cells of the uniform grid of size h over the domain."""
    return math.prod(math.ceil((e - s) / h) for s, e in zip(domain_start, domain_end))
