"""The comparison that decides ``correct``: an answer of the program
against the plain reference (``benchmark.reference``) run in float64
from the same input over the same steps.

An answer is a state: a frame's dump, a chunk's end state, or the start
check's first group.  Rows are matched by their tags (``object_id``, set
by ``benchmark.inputs`` from each row's start row).  The gaps of position
and velocity are the error of what the forces did over the compared
steps, in units of what gravity alone does there: the input is the same
on both sides, so a row's error of its change is its error of its end.

- ``dx_gap``: the largest distance between a row's positions, over
  g dt^2 n (n + 1) / 2, gravity's displacement over n symplectic steps;
- ``dv_gap``: the largest difference of a row's velocities, over g dt n,
  gravity's change of velocity: an error of a row's acceleration by a,
  held over the n steps, reads a / g;
- ``rho_gap``: the largest density difference, over rho0;
- ``p_gap``: the largest pressure difference, over the reference's
  largest pressure;
- ``tie_share``: the share of rows that have a component left out of
  ``dx_gap`` and ``dv_gap`` (below);
- ``lost``: live rows whose tag is missing or repeated, or whose mass,
  volume or material differ from the input's, and dead rows a device
  state holds as live (an exact count); a boundary row also counts where
  its position or velocity is not bitwise the input's (boundary rows are
  static), or where its volume, which the program sets to Akinci's V_b
  when it binds S0, lies farther than :data:`VOLUME_RTOL` of the
  reference's V_b from it;
- ``replay``: 1 where the program's chunk, run again from its input as
  the check's own two calls, is not bitwise the window's (the reference
  follows that second run), else 0.

A dynamic body's rows share its tag (``benchmark.inputs``), and the
program moves them: they take no part in the numbers above but ``lost``.
Each is matched to the reference's row of the same body nearest to it,
within a quarter of the bodies' lattice spacing (the particle diameter;
both sides move the body rigidly, and its rows lie a diameter apart); a
row of the program left unmatched, and a row of the reference matched
none or several times, counts in ``lost``, and so does a matched row
whose mass or material differ from the input's, or whose volume lies
farther than :data:`VOLUME_RTOL` of the reference's V_b from it.  Only
where the scene has a dynamic body, three numbers follow, each the
largest over the bodies:

- ``body_dx_gap``: the largest distance between the COMs, or between a
  row's positions, in ``dx_gap``'s units;
- ``body_dv_gap``: the largest difference of the ``v_com``, or of a row's
  velocities, in ``dv_gap``'s units;
- ``body_w_gap``: the difference of the ``omega`` times the body's
  largest row distance from its COM in the reference, in ``dv_gap``'s
  units: the error of the rows' velocities that the spin alone makes.

A cell's limits file says which numbers decide ``correct`` (``verdict``).

``dx_gap`` and ``dv_gap`` leave out the components of a row on an axis
whose stored position in the reference fell within two float32 steps of
a face of the box in any step (``tie``, per row and axis): an input one
step off, as float32 arithmetic gives, takes the clamp's other branch
there, and the two differ by the reflection, (1 + c_f) times the normal
speed.  The gaps and ``tie_share`` are taken over fluid rows: density and
pressure on every fluid row.

The control is the reference itself run in bfloat16, judged the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.cells import load_module
from benchmark.reference.common import BODY_FIELDS, BOUNDARY, INVALID, physics, to_device

NUMBERS = ("dx_gap", "dv_gap", "rho_gap", "p_gap", "tie_share", "lost", "replay")
BODY_NUMBERS = ("body_dx_gap", "body_dv_gap", "body_w_gap")

# a boundary row's volume against the reference's V_b, relative: the
# program's V_b is 1 over a float32 sum of about 30 kernel values, each
# within a few float32 steps (6e-8) of its own, so it errs by some 2e-6 of
# the sum; bfloat16 errs by 4e-3, and one neighbour left out by about 1/30
VOLUME_RTOL = 1e-4


def reference_steps(cell, inp: dict, steps: int, resort: int, device,
                    dtype=torch.float64) -> dict:
    """``steps`` steps of the reference named by the configuration from
    the host or device state ``inp``, in groups of ``resort``; the
    input's live rows, in its order, with their tags."""
    ph = physics(cell.scene, cell.config["compat"])
    name = cell.config["reference"]
    step = load_module(cell.root / "reference" / f"{name}.py", f"benchmark_reference_{name}")
    st = to_device(inp, device, dtype)
    tie = torch.zeros_like(st["x"], dtype=torch.bool)
    done = 0
    while done < steps:
        k = min(resort, steps - done)
        st = st | step.group(st, k, ph)
        tie |= st["tie"]
        done += k
    return st | {"tie": tie, "steps": steps}


def compare(cell, inp: dict, out: dict, ref: dict, replay: int = 0) -> dict[str, float]:
    """The numbers of the answer ``out`` (host arrays, every row of a
    device state or the live rows of a dump) against ``ref`` (from
    :func:`reference_steps` on ``inp``); ``replay`` as the module says."""
    ph = physics(cell.scene, cell.config["compat"])
    n = int(inp["num_active"])
    tags_in = np.asarray(inp["object_id"][:n]).astype(np.int64)
    rows = np.asarray(out["material"]) != INVALID
    lost = int(np.count_nonzero(~rows[:int(out["num_active"])]))
    lost += int(np.count_nonzero(rows[int(out["num_active"]):]))
    tags = np.asarray(out["object_id"])[rows].astype(np.int64)
    # a dynamic body's rows share its tag: matched by position, below
    body_in = (np.asarray(inp["material"][:n]) == BOUNDARY) & np.isin(tags_in, ph.bodies)
    body_out = (np.asarray(out["material"])[rows] == BOUNDARY) & np.isin(tags, ph.bodies)
    in_rows, out_rows = np.flatnonzero(~body_in), np.flatnonzero(rows)
    body_rows = (np.flatnonzero(body_in), out_rows[body_out])
    tags_in, tags, out_rows = tags_in[~body_in], tags[~body_out], out_rows[~body_out]
    by_tag = np.full(int(max(tags_in.max(initial=0), tags.max(initial=0))) + 1, -1, np.int64)
    by_tag[tags_in] = in_rows
    ref_row = by_tag[np.clip(tags, 0, by_tag.size - 1)]
    seen = np.zeros(n, np.int64)
    ok = (tags >= 0) & (tags < by_tag.size) & (ref_row >= 0)
    np.add.at(seen, ref_row[ok], 1)
    lost += int(np.count_nonzero(~ok)) + int(np.count_nonzero(seen[in_rows] != 1))
    ref_row, keep = ref_row[ok], out_rows[ok]
    wall = np.asarray(inp["material"][:n])[ref_row] == BOUNDARY
    for k in ("mass", "material"):
        lost += int(np.count_nonzero(np.asarray(out[k])[keep] != np.asarray(inp[k][:n])[ref_row]))
    volume = np.asarray(out["volume"])[keep]
    lost += int(np.count_nonzero(volume[~wall] != np.asarray(inp["volume"][:n])[ref_row[~wall]]))
    if wall.any():
        # static rows keep their place bitwise, and carry Akinci's volume
        for k in ("x", "v"):
            moved = np.asarray(out[k])[keep[wall]] != np.asarray(inp[k][:n])[ref_row[wall]]
            lost += int(np.count_nonzero(moved.any(-1)))
        vb = ref["volume_b"].detach().to("cpu", torch.float64).numpy()[ref_row[wall]]
        lost += int(np.count_nonzero(~(np.abs(volume[wall] - vb) <= VOLUME_RTOL * vb)))
        ref_row, keep = ref_row[~wall], keep[~wall]

    def f64(a):
        return torch.as_tensor(np.asarray(a)[keep], dtype=torch.float64)

    idx = torch.as_tensor(ref_row)
    r = {k: ref[k].detach().to("cpu", torch.float64)[idx] for k in ("x", "v", "density",
                                                                    "pressure")}
    # a component whose clamp decision in the reference fell within rounding
    # of a face may take either branch at float32: left out of dx and dv
    tie = ref["tie"].detach().cpu()[idx]
    dx = torch.linalg.vector_norm(torch.where(tie, 0.0, f64(out["x"]) - r["x"]), dim=-1)
    dv = torch.linalg.vector_norm(torch.where(tie, 0.0, f64(out["v"]) - r["v"]), dim=-1)
    steps, g = int(ref["steps"]), math.sqrt(sum(a * a for a in ph.gravity))
    x_unit, v_unit = g * ph.dt ** 2 * steps * (steps + 1) / 2, g * ph.dt * steps

    def worst(d: torch.Tensor, scale: float) -> float:
        return float(d.max()) / scale if d.numel() else 0.0

    numbers = {
        "dx_gap": worst(dx, x_unit),
        "dv_gap": worst(dv, v_unit),
        "rho_gap": worst((f64(out["density"]) - r["density"]).abs(), ph.rho0),
        "p_gap": worst((f64(out["pressure"]) - r["pressure"]).abs(),
                       max(float(r["pressure"].abs().max()), 1e-30)),
        "tie_share": float(tie.any(-1).sum()) / max(idx.numel(), 1),
        "lost": float(lost),
        "replay": float(replay),
    }
    if ph.bodies:
        body_lost, gaps = _bodies(ph, inp, out, ref, *body_rows)
        numbers["lost"] += body_lost
        numbers |= {"body_dx_gap": gaps[0] / x_unit, "body_dv_gap": gaps[1] / v_unit,
                    "body_w_gap": gaps[2] / v_unit}
    return numbers


def _bodies(ph, inp: dict, out: dict, ref: dict, in_rows: np.ndarray, out_rows: np.ndarray
            ) -> tuple[int, tuple[float, float, float]]:
    """The dynamic bodies' rows (``in_rows`` of the input and the
    reference, ``out_rows`` of ``out``) matched by position: their count
    for ``lost``, and the largest gaps of position, velocity and spin in
    metres and metres a second (the module's docstring)."""
    from scipy.spatial import cKDTree

    n = int(inp["num_active"])
    host = {k: ref[k].detach().to("cpu", torch.float64).numpy()
            for k in ("x", "v", "volume_b", "rigid_com", "rigid_v_com", "rigid_omega")}
    tags_in = np.asarray(inp["object_id"][:n])[in_rows]
    tags_out = np.asarray(out["object_id"])[out_rows]
    ids = np.asarray(out.get("rigid_object_ids", np.zeros(0)))
    lost, gaps = 0, np.zeros(3)
    for k, body in enumerate(ph.bodies):
        mine, theirs = in_rows[tags_in == body], out_rows[tags_out == body]
        x_out = np.asarray(out["x"])[theirs].astype(np.float64)
        d, near = cKDTree(host["x"][mine]).query(x_out, distance_upper_bound=0.5 * ph.radius)
        hit = np.isfinite(d)
        seen = np.bincount(near[hit], minlength=mine.size)
        lost += int(np.count_nonzero(~hit)) + int(np.count_nonzero(seen != 1))
        one = hit & (seen[np.minimum(near, mine.size - 1)] == 1)
        o, r = theirs[one], mine[near[one]]
        for f in ("mass", "material"):
            lost += int(np.count_nonzero(np.asarray(out[f])[o] != np.asarray(inp[f][:n])[r]))
        vb = host["volume_b"][r]
        lost += int(np.count_nonzero(~(np.abs(np.asarray(out["volume"])[o] - vb)
                                       <= VOLUME_RTOL * vb)))
        at = np.flatnonzero(ids == body)
        if at.size != 1 or "rigid_com" not in out:  # the body's state is not in the answer
            return lost + 1, (math.nan,) * 3
        a = int(at[0])

        def dist(p, q):
            return float(np.linalg.norm(np.asarray(p, np.float64) - q, axis=-1).max(
                initial=0.0))

        reach = dist(host["x"][mine], host["rigid_com"][k])
        gaps = np.maximum(gaps, [
            max(dist(x_out[one], host["x"][r]), dist(out["rigid_com"][a], host["rigid_com"][k])),
            max(dist(np.asarray(out["v"])[o], host["v"][r]),
                dist(out["rigid_v_com"][a], host["rigid_v_com"][k])),
            dist(out["rigid_omega"][a], host["rigid_omega"][k]) * reach])
    return lost, tuple(float(g) for g in gaps)


def as_answer(ref: dict, dtype_in: dict) -> dict:
    """A reference result as an answer (host arrays in the program's
    field names, live rows in the input's order): the control's output,
    with its own V_b as the volume of each boundary row."""
    n = ref["x"].shape[0]
    out = {k: ref[k].detach().to("cpu", torch.float64).numpy() for k in
           ("x", "v", "density", "pressure")}
    for k in ("mass", "volume", "material", "object_id"):
        out[k] = np.asarray(dtype_in[k][:n])
    wall = out["material"] == BOUNDARY
    if wall.any():
        vb = ref["volume_b"].detach().to("cpu", torch.float64).numpy()
        out["volume"] = np.where(wall, vb, out["volume"])
    if "rigid_object_ids" in ref:
        out["rigid_object_ids"] = ref["rigid_object_ids"].detach().cpu().numpy()
        out |= {k: ref[k].detach().to("cpu", torch.float64).numpy() for k in BODY_FIELDS}
    return out | {"num_active": np.asarray(n)}


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    """Each number's largest reading over the answers compared (NaN wins),
    in the order of the first answer's."""
    out = {}
    for k in readings[0]:
        vals = [r[k] for r in readings]
        out[k] = float("nan") if any(v != v for v in vals) else max(vals)
    return out


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number that ``limits`` holds at or under its limit (a NaN, or
    a number not read, is over it)."""
    return all(numbers.get(k, math.nan) <= limits[k] for k in limits)
