"""A plain uniform cell list: cells of size h over the scene's domain.

Every pair (i, j) with |x_i - x_j| < h at the binning positions lies in
one of the 3^dim cells around i's cell, so the candidates of a row are
the rows of those cells.  A row's cell is Ti-SPH's ``pos_to_index``,
(x - domain_start) / h floored, in float32 as Ti-SPH computes it: a row
on a face of the grid, as boundary lattices are, lies in the cell that
float32 gives, and a pair that motion within a group brings inside h is
a candidate exactly where it is in the float32 grid.  Used by the
reference steps and by the pair counts of ``benchmark.work``; it imports
nothing of the measured program.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterator, Sequence

import torch

# candidate pairs per chunk: bounds the transient memory of one chunk
# (about a dozen tensors of this length)
PAIR_BUDGET = 1 << 24


class CellList:
    """The rows ``rows`` of positions ``x`` binned into cells of size
    ``h`` over [domain_start, domain_end], coordinates clipped into the
    grid."""

    def __init__(self, x: torch.Tensor, rows: torch.Tensor, domain_start: Sequence[float],
                 domain_end: Sequence[float], h: float):
        dim = x.shape[1]
        self.res = [int(math.ceil((e - s) / h)) for s, e in zip(domain_start, domain_end)]
        dev = x.device
        start = torch.tensor(domain_start, dtype=torch.float32, device=dev)
        hi = torch.tensor([r - 1 for r in self.res], dtype=torch.int64, device=dev)
        c = torch.floor((x[rows].to(torch.float32) - start) / h).to(torch.int64)
        self.coords = torch.minimum(torch.clamp(c, min=0), hi)  # (len(rows), dim)
        self.strides = [math.prod(self.res[a + 1:]) for a in range(dim)]
        flat = self._flat(self.coords)
        flat, order = torch.sort(flat)
        self.sorted_rows = rows[order]
        cells = torch.arange(math.prod(self.res) + 1, device=dev)
        self.first = torch.searchsorted(flat, cells)  # CSR: rows of cell c are first[c]:first[c+1]
        self.rows = rows
        self.dim = dim
        self._offsets = torch.tensor(list(itertools.product((-1, 0, 1), repeat=dim)),
                                     dtype=torch.int64, device=dev)

    def _flat(self, coords: torch.Tensor) -> torch.Tensor:
        s = torch.tensor(self.strides, dtype=torch.int64, device=coords.device)
        return (coords * s).sum(-1)

    def candidates(self, which: torch.Tensor | None = None,
                   budget: int = PAIR_BUDGET) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Chunks (i, j) of every binned row j in the cells around binned
        row i (self pair included), over the binned rows i selected by the
        bool mask ``which`` (aligned with ``rows``; None: all)."""
        sel = torch.arange(self.rows.numel(), device=self.rows.device)
        if which is not None:
            sel = sel[which]
        if sel.numel() == 0:
            return
        nb = self.coords[sel][:, None, :] + self._offsets[None]  # (n, 3^dim, dim)
        res = torch.tensor(self.res, dtype=torch.int64, device=nb.device)
        inside = ((nb >= 0) & (nb < res)).all(-1)
        cell = torch.where(inside, self._flat(nb.clamp(min=0)), 0)
        lo = self.first[cell]
        ln = torch.where(inside, self.first[cell + 1] - lo, 0)
        per_row = ln.sum(1)
        ends = torch.cumsum(per_row, 0)
        marks = torch.arange(1, int(ends[-1]) // budget + 1, device=ends.device) * budget
        cuts = torch.searchsorted(ends, marks, right=True).tolist()
        for a, b in zip([0] + cuts, cuts + [sel.numel()]):
            if a >= b:
                continue
            l_seg = ln[a:b].reshape(-1)
            seg = torch.repeat_interleave(torch.arange(l_seg.numel(), device=l_seg.device),
                                          l_seg)
            pos = torch.arange(seg.numel(), device=seg.device) - (torch.cumsum(l_seg, 0)
                                                                   - l_seg)[seg]
            j = self.sorted_rows[lo[a:b].reshape(-1)[seg] + pos]
            i = self.rows[sel[a + torch.div(seg, ln.shape[1], rounding_mode="floor")]]
            yield i, j
