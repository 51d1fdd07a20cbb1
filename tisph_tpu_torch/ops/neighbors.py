"""Neighbour sweeps over the cell-sorted state: the plain PyTorch versions
of the sweep kernel (``ops.cuda.sweeps``), with the same signatures.

Five modes, each a sum over the candidates j of a row i:

- ``density``:  rho_i = k_sig sum_j effm_j w_ij, self term included;
- ``bvol``:     delta_i = k_sig sum_j bd_j w_ij (Akinci boundary volume
  denominator, self term included);
- ``force``:    dv_i = g + (k_sig / h) sum_j coef_ij dx_ij, the fused
  viscosity, pressure and cohesion terms of ``tisph_tpu``'s TPU sweep
  kernel (ops/pallas/sweeps.py ``_tile_math``, lines 181-297);
- ``reaction``: F_i = (k_sig / h) sum_j bvol_i flm_j (nu_b,j dot_neg_ij -
  p_j / rho_j^2) gmag_ij dx_ij on boundary rows, the fluid -> boundary
  force of the two-way rigid coupling, with nu_b,j = sigma_b h c_s /
  (2 max(rho_j, 1e-12)) and bvol_i = rho0 V_i read from the ``pos`` c
  column (effm is rho0 V on boundary rows);
- ``force_react``: ``force`` on fluid rows and ``reaction`` on boundary
  rows, each with the arithmetic of its separate mode, so the fused output
  equals them bitwise on their rows.

The candidates of i are every j whose sort-time cell id lies in one of
i's 3^(dim-1) sort-time stencil-row ranges (``grid.stencil_runs`` over the
rebuild's bounds, i's cell decoded from its sort-time id); positions are
current.  The branch-free spline w = 2(1-q)+^3 - 8(1/2-q)+^3 is exactly 0
for q >= 1, so the r < h cutoff needs no separate test, and the force
mode's self pair gives exactly 0 because dx is bitwise 0 (x_i and x_j are
read from the same tensor) while the rsqrt clamp keeps coef finite.  Only
rows of the mode's consumer family are computed (fluid rows for
``density`` and ``force``, boundary rows for ``bvol`` and ``reaction``,
both for ``force_react``); other rows are 0.

The ``*_linear`` versions (``density`` and ``force``) are the plain
versions of the linear-layout sweep kernel: the same pair set and pair
arithmetic, with the candidates drawn from per-block windows and an id
test (:func:`candidates`).

The ``legacy_*`` versions are the legacy (V1) solver's two pair sums
(``models.wcsph_legacy``), the plain versions of ``csrc/legacy.cu``:
over every candidate j != i with r^2 < h^2 (``tisph_tpu/ops/
neighbors.py:160-163``), with the piecewise cubic spline of
``ops.kernels``; see :func:`legacy_density_sweep` and
:func:`legacy_force_sweep` for their packs.

Inputs are float4-style packs (:func:`pack4`, :func:`pack_aux`), (N, 4) f32:

- ``pos`` = [x, y, z or 0, c] with c = effm (density and the gradient
  modes) or bd (bvol);
- ``vel`` = [vx, vy, vz or 0, rho];
- ``aux`` = [p / max(rho^2, 1e-12), fl * m, m, 0].

``fast_math`` is accepted for the kernel's signature and has no effect
here: the plain versions always divide exactly, as ``tisph_tpu``'s
interpret mode does.
"""

from __future__ import annotations

import torch

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.models.state import MATERIAL_BOUNDARY, MATERIAL_FLUID
from tisph_tpu_torch.ops.grid import (
    GridSpec,
    block_window_bounds,
    cell_target_ranges,
    coords_from_ids,
    stencil_runs,
)
from tisph_tpu_torch.ops.consts import device_constant
from tisph_tpu_torch.ops.kernels import cubic_kernel, cubic_kernel_grad, cubic_kernel_sigma

# Candidate pairs per chunk of rows i: bounds the plain sweep's transient
# memory (~40 tensors of this length in the force mode) so 195k particles
# fit on a card or a host.
_PAIR_BUDGET = 1 << 22

# i rows per block of the linear layout: SweepConfig.block_size's default,
# the block of tisph_tpu's linear TPU kernel and one CTA of the CUDA one
LINEAR_BLOCK = 128

# consumer family (row materials) of each mode
_FAMILY = {
    "density": (MATERIAL_FLUID,),
    "force": (MATERIAL_FLUID,),
    "bvol": (MATERIAL_BOUNDARY,),
    "reaction": (MATERIAL_BOUNDARY,),
    "force_react": (MATERIAL_FLUID, MATERIAL_BOUNDARY),
}
_GRAD = ("force", "force_react", "reaction")  # the (N, dim) gradient modes


def pack4(vec: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, 4) f32 contiguous pack: ``vec`` (N, dim <= 3) in columns
    [0, dim), zeros up to column 3, ``w`` (N,) in column 3."""
    n, dim = vec.shape
    out = torch.zeros((n, 4), dtype=torch.float32, device=vec.device)
    out[:, :dim] = vec
    out[:, 3] = w
    return out


def pack_aux(p_rho2: torch.Tensor, flm: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """(N, 4) f32 pack [p / max(rho^2, 1e-12), fl * m, m, 0]."""
    return torch.stack([p_rho2, flm, mass, torch.zeros_like(mass)], dim=1)


def candidates(ids, bounds, rows_i, spec: GridSpec, layout: str = "seg",
               blocks: tuple[int, int] | None = None):
    """Yields the candidate pairs of the rows ``rows_i`` (int64) as chunks
    ``(i, j)`` of about ``_PAIR_BUDGET`` pairs.

    - ``seg``: every j of i's stencil runs (``grid.stencil_runs``);
    - ``linear``: every j of i's block window in each stencil row
      (``grid.block_window_bounds`` over blocks of ``LINEAR_BLOCK`` of the
      rows ``blocks=(row0, n)``, by default every row, windows read out of
      ``bounds``) whose id lies in
      i's range of that row (``grid.cell_target_ranges``), as
      ``tisph_tpu``'s linear TPU kernel tests it (ops/pallas/sweeps.py:483).

    Both give the same pair set; i's cell is decoded from its sort-time id.
    """
    for k, j in _pairs(ids, bounds, rows_i, spec, layout, blocks):
        yield rows_i[k], j


def _pairs(ids, bounds, rows_i, spec: GridSpec, layout: str, blocks):
    """:func:`candidates` as ``(k, j)``: i = rows_i[k]."""
    dev = ids.device
    rows = spec.num_rows
    coords_i = coords_from_ids(ids[rows_i], spec)
    if layout == "seg":
        runs = stencil_runs(coords_i, bounds, spec).long()
        starts, ends = runs[..., 0], runs[..., 1]
    elif layout == "linear":
        # the blocks of the swept rows [row0, row0 + n): their windows, and
        # the block of each row i
        row0, n = blocks if blocks is not None else (0, ids.shape[0])
        ids_b = ids[row0:row0 + n]
        w_lo, w_hi = block_window_bounds(ids, coords_from_ids(ids_b, spec), spec,
                                         LINEAR_BLOCK, ids_i=ids_b, bounds=bounds)
        blk = torch.div(rows_i - row0, LINEAR_BLOCK, rounding_mode="floor")
        starts, ends = w_lo.long()[blk], w_hi.long()[blk]
        ranges = cell_target_ranges(coords_i, spec).reshape(-1, 2)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    lens = torch.clamp(ends - starts, min=0).reshape(-1)  # per (i, stencil row)
    starts = starts.reshape(-1)
    # chunks of whole rows i holding about _PAIR_BUDGET candidate pairs
    per_i = torch.cumsum(lens.reshape(-1, rows).sum(1), 0)
    cuts = torch.searchsorted(
        per_i, torch.arange(1, int(per_i[-1]) // _PAIR_BUDGET + 1, device=dev)
        * _PAIR_BUDGET).tolist()
    for c0, c1 in zip([0] + cuts, cuts + [rows_i.numel()]):
        if c0 >= c1:
            continue
        # every j of every run of rows c0..c1, without padding
        ln = lens[c0 * rows:c1 * rows]
        run = torch.repeat_interleave(torch.arange(ln.numel(), device=dev), ln)
        first = torch.cumsum(ln, 0) - ln
        j = starts[c0 * rows:c1 * rows][run] + (torch.arange(run.numel(), device=dev) - first[run])
        k = c0 + torch.div(run, rows, rounding_mode="floor")
        if layout == "linear":
            rng = ranges[c0 * rows + run]
            idj = ids[j]
            keep = torch.nonzero((idj >= rng[:, 0]) & (idj <= rng[:, 1])).squeeze(1)
            k, j = k[keep], j[keep]
        yield k, j


def row_range(rows, n: int, name: str) -> tuple[int, int]:
    """(row0, count) of a sweep's ``rows`` argument over arrays of ``n``
    rows: ``(row0, count)`` as given, or every row for None."""
    if rows is None:
        return 0, n
    row0, count = (int(r) for r in rows)
    if row0 < 0 or count < 0 or row0 + count > n:
        raise ValueError(f"{name}: rows ({row0}, {count}) outside the {n} rows of the arrays")
    return row0, count


def check_row_map(irows, ids, name: str) -> None:
    """An i-row map must be an (n,) int32 contiguous tensor on the arrays'
    device; its entries are not read here (on a card that would wait)."""
    if (irows.dtype != torch.int32 or irows.dim() != 1 or not irows.is_contiguous()
            or irows.device != ids.device):
        raise ValueError(f"{name}: an i-row map must be a contiguous (n,) int32 tensor on "
                         f"{ids.device}, got {tuple(irows.shape)} {irows.dtype} on "
                         f"{irows.device}")


def _sweep(mode: str, pos, vel, aux, ids, bounds, material,
           spec: GridSpec, params: SolverParams, layout: str = "seg",
           rows=None) -> torch.Tensor:
    name = f"{mode}_sweep"
    if isinstance(rows, torch.Tensor):  # an i-row map: row t of the output is row rows[t]
        check_row_map(rows, ids, name)
        if layout != "seg":
            raise ValueError(f"{name}_{layout}: takes a row range, not an i-row map")
        irows, row0, count = rows.long(), 0, rows.shape[0]
    else:
        irows = None
        row0, count = row_range(rows, pos.shape[0], name)
    dim = spec.dim
    h = params.support_length
    k_sig = cubic_kernel_sigma(dim, h)
    grad = mode in _GRAD
    # the mode's family among the swept rows; the candidates j range over
    # every row
    material = material[irows] if irows is not None else material[row0:row0 + count]
    fam = material == _FAMILY[mode][0]
    for m in _FAMILY[mode][1:]:
        fam = fam | (material == m)
    fluid = material == MATERIAL_FLUID
    acc = torch.zeros((count, dim if grad else 1), dtype=torch.float32, device=pos.device)
    ts = torch.nonzero(fam).squeeze(1)  # output rows of the family
    rows_i = irows[ts] if irows is not None else ts + row0  # their rows in the arrays
    if rows_i.numel() == 0:
        return acc if grad else acc[:, 0]

    # q >= 1 gives exactly 0 in every term (spline clamps), so pairs past
    # r^2 = h^2 (with a margin that keeps every q < 1 pair) change no sum;
    # dropping them first saves ~85% of the math.
    r2_keep = 1.0001 * h * h

    for k, j in _pairs(ids, bounds, rows_i, spec, layout, (row0, count)):
        i, t = rows_i[k], ts[k]
        pi, pj = pos.index_select(0, i), pos.index_select(0, j)
        dx = [pi[:, a] - pj[:, a] for a in range(dim)]
        r2 = dx[0] * dx[0]
        for a in range(1, dim):
            r2 = r2 + dx[a] * dx[a]
        near = torch.nonzero(r2 < r2_keep).squeeze(1)
        i, t, j, r2, pi, pj = i[near], t[near], j[near], r2[near], pi[near], pj[near]
        dx = [d[near] for d in dx]
        rs = torch.rsqrt(torch.clamp(r2, min=1e-12))
        q = (r2 * rs) * (1.0 / h)
        p1 = torch.clamp(1.0 - q, min=0.0)
        p2 = torch.clamp(0.5 - q, min=0.0)
        p1sq = p1 * p1
        p2sq = p2 * p2
        w = 2.0 * p1 * p1sq - 8.0 * p2 * p2sq

        if not grad:
            acc[:, 0].index_add_(0, t, pj[:, 3] * w)
            continue

        vi, vj, aj = vel[i], vel[j], aux[j]
        gmag = (24.0 * p2sq - 6.0 * p1sq) * rs
        flm = aj[:, 1]
        dot = (vi[:, 0] - vj[:, 0]) * dx[0]
        for a in range(1, dim):
            dot = dot + (vi[:, a] - vj[:, a]) * dx[a]
        dot_neg = torch.clamp(dot, max=0.0) / (r2 + 0.01 * h * h)
        coef = None
        if mode != "reaction":
            ai = aux[i]
            rho_i = vi[:, 3]
            p_rho2_i = ai[:, 0]
            coh_i = -((h * params.surface_tension) * (1.0 / torch.clamp(ai[:, 2], min=1e-30)))
            nu_b_i = (params.boundary_sigma * h * params.c_s) / (2.0 * rho_i)
            effm = pj[:, 3]
            bdv = effm - flm
            inv_rho_sum = 1.0 / (rho_i + vj[:, 3])
            nu_f = (2.0 * params.viscosity * h * params.c_s) * inv_rho_sum
            visc = dot_neg * (flm * nu_f + bdv * nu_b_i)
            press = effm * p_rho2_i + flm * aj[:, 0]
            coef = (visc - press) * gmag + (coh_i * flm) * w
        if mode != "force":
            inv_rho_j = 1.0 / torch.clamp(vj[:, 3], min=1e-12)
            nu_b_j = (params.boundary_sigma * h * params.c_s * 0.5) * inv_rho_j
            react = (pi[:, 3] * (flm * (nu_b_j * dot_neg - aj[:, 0]))) * gmag
            coef = react if coef is None else torch.where(fluid[t], coef, react)
        for a in range(dim):
            acc[:, a].index_add_(0, t, coef * dx[a])

    if not grad:
        return acc[:, 0] * k_sig  # rows outside the family were never added to
    out = acc * (k_sig / h)
    if mode != "reaction":  # gravity on fluid rows only
        g = torch.tensor(params.gravity[:dim], dtype=torch.float32, device=pos.device)
        out = torch.where(fluid[:, None], out + g, out)
    return torch.where(fam[:, None], out, acc.new_zeros(()))


def density_sweep(pos, ids, bounds, material, spec: GridSpec,
                  params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N,) density on fluid rows, 0 elsewhere.  ``pos`` c column = effm.
    ``rows``, in every mode of the seg sweep: None sweeps every row;
    ``(row0, n)`` rows [row0, row0 + n); an (n,) int32 tensor (an i-row
    map) the rows it lists, row t of the output being row ``rows[t]``.
    The candidates lie anywhere in the arrays and the output has n rows."""
    return _sweep("density", pos, None, None, ids, bounds, material, spec, params,
                  rows=rows)


def bvol_sweep(pos, ids, bounds, material, spec: GridSpec,
               params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N,) boundary-volume denominator on boundary rows, 0 elsewhere.
    ``pos`` c column = bd (1 on boundary rows)."""
    return _sweep("bvol", pos, None, None, ids, bounds, material, spec, params, rows=rows)


def force_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N, dim) acceleration on fluid rows, 0 elsewhere."""
    return _sweep("force", pos, vel, aux, ids, bounds, material, spec, params, rows=rows)


def force_react_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                      params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N, dim): acceleration on fluid rows, fluid -> boundary reaction
    force on boundary rows, 0 elsewhere."""
    return _sweep("force_react", pos, vel, aux, ids, bounds, material, spec, params,
                  rows=rows)


def reaction_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                   params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """(N, dim) fluid -> boundary reaction force on boundary rows, 0
    elsewhere.  ``pos`` c column = effm (rho0 V on boundary rows)."""
    return _sweep("reaction", pos, vel, aux, ids, bounds, material, spec, params, rows=rows)


def density_sweep_linear(pos, ids, bounds, material, spec: GridSpec, params: SolverParams,
                         fast_math: bool = True, rows=None) -> torch.Tensor:
    """``density_sweep`` over the linear layout's block windows: (N,)
    density on fluid rows, 0 elsewhere.  ``rows=(row0, n)``: the blocks of
    128 rows start at row0 and the output has n rows; None is every row."""
    return _sweep("density", pos, None, None, ids, bounds, material, spec, params, "linear",
                  rows)


def force_sweep_linear(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                       params: SolverParams, fast_math: bool = True, rows=None) -> torch.Tensor:
    """``force_sweep`` over the linear layout's block windows: (N, dim)
    acceleration on fluid rows, 0 elsewhere; ``rows`` as in
    :func:`density_sweep_linear`."""
    return _sweep("force", pos, vel, aux, ids, bounds, material, spec, params, "linear", rows)


def legacy_masses(params: SolverParams) -> tuple[float, float]:
    """(m_V, m_V rho0) of the legacy solver: the scalar m_V = 0.8 d^dim
    of the particle diameter d, and the mass of its viscosity."""
    m_v = 0.8 * (2.0 * params.particle_radius) ** params.dim
    return m_v, m_v * params.density0


def legacy_pos(state) -> torch.Tensor:
    """The legacy sums' ``pos`` pack of a sorted state: [x, fl], fl 1 on
    fluid rows, else 0."""
    return pack4(state.x, state.fluid_mask.to(torch.float32))


def legacy_force_packs(state, rho: torch.Tensor,
                       pressure: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The legacy force sum's ``vel`` and ``aux`` packs of a sorted state
    with the step's ``rho`` and ``pressure``: [v, rho] and [p / rho^2, V,
    bd, 0], bd 1 on live rows off the fluid family, else 0."""
    bound = (~state.fluid_mask & state.active_mask).to(torch.float32)
    aux = torch.stack([pressure / (rho * rho), state.volume, bound, torch.zeros_like(bound)],
                      dim=1)
    return pack4(state.v, rho), aux


def _legacy_pairs(x, ids, bounds, material, spec: GridSpec, params: SolverParams):
    """The pairs (i, j) of the fluid rows with j != i and r^2 < h^2, as
    chunks ``(i, j, r, r2)`` with r = x_i - x_j."""
    h2 = params.support_length ** 2
    rows = torch.nonzero(material == MATERIAL_FLUID).squeeze(1)
    for i, j in candidates(ids, bounds, rows, spec):
        r = x[i] - x[j]
        r2 = torch.sum(r * r, dim=-1)
        keep = torch.nonzero((r2 < h2) & (i != j)).squeeze(1)
        yield i[keep], j[keep], r[keep], r2[keep]


def legacy_density_sweep(pos, ids, bounds, material, spec: GridSpec,
                         params: SolverParams) -> torch.Tensor:
    """(N,) rho_i = rho0 sum over fluid j of m_V W_ij on fluid rows, 0
    elsewhere.  ``pos`` = [x, fl] (fl 1 on fluid rows, else 0)."""
    dim, h = spec.dim, params.support_length
    m_v, _ = legacy_masses(params)
    x, fl = pos[:, :dim], pos[:, 3]
    acc = torch.zeros_like(fl)
    for i, j, _, r2 in _legacy_pairs(x, ids, bounds, material, spec, params):
        acc.index_add_(0, i, fl[j] * m_v * cubic_kernel(torch.sqrt(r2), h, dim))
    return torch.where(material == MATERIAL_FLUID, params.density0 * acc, 0.0)


def legacy_force_sweep(pos, vel, aux, ids, bounds, material, spec: GridSpec,
                       params: SolverParams) -> torch.Tensor:
    """(N, dim) dv_i on fluid rows, 0 elsewhere: gravity -9.80 on the last
    axis plus, over every pair, the viscosity 2 (dim + 2) nu (m_V rho0 /
    rho_j) (v_ij . r) / (r^2 + 0.01 h^2) grad W, the fluid pressure term
    -rho0 m_V (p_i / rho_i^2 + p_j / rho_j^2) grad W and the boundary term
    -rho0 V_j (p_i / rho_i^2) grad W.  ``pos`` = [x, fl], ``vel`` = [v,
    rho], ``aux`` = [p / rho^2, V, bd, 0] (bd 1 on live non-fluid rows)."""
    dim, h = spec.dim, params.support_length
    m_v, mass = legacy_masses(params)
    x, fl = pos[:, :dim], pos[:, 3]
    v, rho = vel[:, :dim], vel[:, 3]
    p_rho2, volume, bound = aux[:, 0], aux[:, 1], aux[:, 2]
    visc = 2.0 * (dim + 2) * params.viscosity
    gravity = device_constant([0.0] * (dim - 1) + [-9.80], torch.float32, pos.device)
    dv = gravity.expand_as(x).clone()
    for i, j, r, r2 in _legacy_pairs(x, ids, bounds, material, spec, params):
        dot = torch.sum((v[i] - v[j]) * r, dim=-1)
        coef = visc * (mass / rho[j]) * dot / (r2 + 0.01 * h * h)
        coef = coef - fl[j] * (params.density0 * m_v) * (p_rho2[i] + p_rho2[j])
        coef = coef - bound[j] * (params.density0 * volume[j]) * p_rho2[i]
        dv.index_add_(0, i, coef[:, None] * cubic_kernel_grad(r, h, dim))
    return torch.where((material == MATERIAL_FLUID)[:, None], dv, 0.0)
