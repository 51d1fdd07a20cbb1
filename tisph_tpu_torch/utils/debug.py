"""Debug-mode validation: the counterpart of ``tisph_tpu.utils.debug``.

- :func:`validate_state`: a host-side sweep over a SimState's invariants
  (finite values, positions in the domain box, positive mass and volume
  on live rows, ``num_active`` equal to the live-row count), with
  ``tisph_tpu``'s messages;
- :func:`checked_step`: wraps a step function.  PyTorch has no checkify,
  so the step runs as it is and its result is checked on the host after
  it (one copy of x, v, density and material to the host per call), and
  a failed check raises.
"""

from __future__ import annotations

import numpy as np

from tisph_tpu_torch.config import SolverParams
from tisph_tpu_torch.models.state import MATERIAL_INVALID, SimState


def validate_state(state: SimState, params: SolverParams, strict: bool = True) -> list[str]:
    """Host-side invariant sweep; returns a list of violation messages
    (raises AssertionError when ``strict`` and violations exist)."""
    mat = state.material.cpu().numpy()
    act = mat != MATERIAL_INVALID
    x = state.x.cpu().numpy()[act]
    v = state.v.cpu().numpy()[act]
    problems: list[str] = []

    if not np.isfinite(x).all():
        problems.append(f"non-finite positions: {(~np.isfinite(x)).sum()} values")
    if not np.isfinite(v).all():
        problems.append(f"non-finite velocities: {(~np.isfinite(v)).sum()} values")
    lo = np.asarray(params.domain_start)
    hi = np.asarray(params.domain_end)
    if x.size and ((x < lo - 1e-5).any() or (x > hi + 1e-5).any()):
        problems.append("particles outside the domain box")
    m = state.mass.cpu().numpy()[act]
    vol = state.volume.cpu().numpy()[act]
    if x.size and ((m <= 0).any() or (vol <= 0).any()):
        problems.append("non-positive mass/volume on active particles")
    n_active = int(state.num_active)
    if act.sum() != n_active:
        problems.append(
            f"num_active ({n_active}) != active material count ({act.sum()})"
        )
    if strict and problems:
        raise AssertionError("; ".join(problems))
    return problems


def check_result(out: SimState, params: SolverParams | None = None) -> None:
    """Raises RuntimeError naming the first failed check of a step's
    result: finite positions, velocities and densities on live rows, and
    with ``params`` positions inside the domain box (1e-5 slack).  Only
    the result is checked, as ``tisph_tpu``'s ``checked_step`` does: rows
    off the live set may hold anything."""
    act = (out.material != MATERIAL_INVALID).cpu().numpy()
    x = out.x.cpu().numpy()[act]
    checks = [
        (np.isfinite(x).all(), "non-finite positions after step"),
        (np.isfinite(out.v.cpu().numpy()[act]).all(), "non-finite velocities after step"),
        (np.isfinite(out.density.cpu().numpy()[act]).all(), "non-finite densities after step"),
    ]
    if params is not None:
        lo = np.asarray(params.domain_start) - 1e-5
        hi = np.asarray(params.domain_end) + 1e-5
        checks.append((((x >= lo) & (x <= hi)).all(), "particles left the domain box"))
    for ok, msg in checks:
        if not ok:
            raise RuntimeError(msg)


def checked_step(step_fn, params: SolverParams | None = None):
    """``step_fn`` (state -> state) with its result checked on the host
    after every call (:func:`check_result`); the wrapped step returns the
    state or raises.

    >>> step = checked_step(solver.step, solver.params)
    >>> state = step(state)   # RuntimeError on a non-finite or escaped row
    """

    def wrapped(state: SimState) -> SimState:
        out = step_fn(state)
        check_result(out, params)
        return out

    return wrapped
