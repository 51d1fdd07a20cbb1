"""The check on tiny cells on the CPU: the program passes with the
full-size cells' limits; the control (the bfloat16 reference in the
program's place) and each fault planted under the timed path fail."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs
from benchmark.cells import load_cell
from benchmark.program import Program
from benchmark.tests import tiny

TINY = [f"{c}.{m}" for c in tiny.TINY_SCENES for m in tiny.MIXES]
WALLS = [f"{c}.{m}" for c in tiny.WALLS for m in tiny.MIXES]
BODIES = [f"{c}.{m}" for c in tiny.BODIES for m in tiny.MIXES]


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", TINY)
def test_program_passes(bench_json, cell):
    line = tiny.run(bench_json, cell)
    assert line["correct"] and line["failed"] == 0, line["checked"]
    assert line["attempted"] > 0


@pytest.mark.parametrize("cell", TINY)
def test_control_fails(bench_json, cell):
    """Three seeds: the reference in bfloat16 put in the program's place
    fails the cell's limits on every one, while the program passes."""
    c = load_cell(cell, bench_json)
    dev = torch.device("cpu")
    prog = None
    for seed in (3, 2 ** 31 + 11, 2 ** 40 + 5):
        s0 = inputs.start_state(c.scene, float(c.config["jitter"]), seed, c.scene_path.parent)
        if prog is None:
            prog, s0_dev, _ = harness.setup(Program, c, s0, dev)
        else:
            s0_dev = prog.start(s0)
        rec, kept = harness.measure(prog, c, s0_dev, s0, seed, 1, False)
        todo = harness.answers(prog, c, kept, s0_dev, s0)
        ours, ctrl = harness.judge(c, todo, dev, control=True)
        limits = c.limits["limits"]
        assert check.verdict(check.worst(ours), limits), check.worst(ours)
        assert not check.verdict(check.worst(ctrl), limits), check.worst(ctrl)


def _unchanged(monkeypatch):
    """A step that returns its state unchanged (the bodies' too)."""
    import tisph_tpu_torch.models.wcsph as w
    import tisph_tpu_torch.models.wcsph_legacy as wl
    import tisph_tpu_torch.models.wcsph_rigid as wr

    for cls in (w.WCSPH, wl.WCSPHLegacy):
        monkeypatch.setattr(cls, "_apply", lambda self, state, cache, **kw: state)
    monkeypatch.setattr(wr.WCSPHRigid, "_coupled_substep", lambda self, carry, cache: carry)


def _half_left_out(monkeypatch):
    """Half of the particles left out of each step: every second row
    keeps the state it had."""
    import tisph_tpu_torch.models.wcsph as w
    import tisph_tpu_torch.models.wcsph_legacy as wl

    for cls in (w.WCSPH, wl.WCSPHLegacy):
        step = cls._apply

        def half(self, state, cache, _step=step, **kw):
            new = _step(self, state, cache, **kw)
            new, *reactions = new if isinstance(new, tuple) else (new,)
            keep = torch.zeros(state.capacity, dtype=torch.bool)
            keep[::2] = True
            new = dataclasses.replace(new, **{
                k: torch.where(keep.view(-1, *[1] * (getattr(new, k).dim() - 1)),
                               getattr(state, k), getattr(new, k))
                for k in ("x", "v", "density", "pressure")})
            return (new, *reactions) if reactions else new

        monkeypatch.setattr(cls, "_apply", half)


def _one_answer_altered(monkeypatch):
    """One particle's position moved by h where ``advance`` produces it."""
    import tisph_tpu_torch as tt

    advance = tt.advance

    def altered(solver, state, rigid, steps, ems=None):
        st, rigid, ems = advance(solver, state, rigid, steps, ems)
        x = st.x.clone()
        x[3] += solver.params.support_length
        return dataclasses.replace(st, x=x), rigid, ems

    monkeypatch.setattr(tt, "advance", altered)


def _physics(name):
    """The solver built with a fault of ``benchmark.program.FAULTS``: the
    force sum without viscosity, or the pressure scaled by 0.9."""
    def plant(monkeypatch):
        from tisph_tpu_torch import config

        from benchmark.program import FAULTS

        make = config.SolverParams.from_scene.__func__
        monkeypatch.setattr(config.SolverParams, "from_scene", classmethod(
            lambda cls, scene, compat="reference": FAULTS[name](make(cls, scene, compat),
                                                                None)[0]))
    plant.__name__ = f"_{name}"
    return plant


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _one_answer_altered,
                                   _physics("viscosity_dropped"),
                                   _physics("pressure_scaled")])
@pytest.mark.parametrize("cell", TINY)
def test_faults_fail(bench_json, cell, fault, monkeypatch):
    """A run with the timed path broken underneath reads ``correct``
    false.  (One card: no exchange between chips to leave out.)"""
    fault(monkeypatch)
    line = tiny.run(bench_json, cell)
    assert not line["correct"], line["checked"]


@pytest.mark.parametrize("cell", BODIES)
def test_body_fault_fails(bench_json, cell, monkeypatch):
    """The fluid's reactions on the bodies scaled by 0.9 before the bodies'
    sums (``reactions_scaled``, the fluid's own step untouched) reads
    ``correct`` false in a cell with a dynamic body."""
    import tisph_tpu_torch as tt
    import tisph_tpu_torch.models.wcsph_rigid as wr

    from benchmark.program import FAULTS

    faulty = FAULTS["reactions_scaled"](None, wr.WCSPHRigid)[1]
    monkeypatch.setattr(tt, "WCSPHRigid", faulty)
    line = tiny.run(bench_json, cell)
    assert not line["correct"], line["checked"]
    assert line["checked"]["body_dv_gap"]["value"] > tiny.BODY_LIMITS["body_dv_gap"]


@pytest.mark.parametrize("cell", WALLS)
def test_boundary_fault_fails(bench_json, cell, monkeypatch):
    """Akinci's boundary viscosity left out of the program reads
    ``correct`` false in a cell with boundary rows (without them the fault
    changes nothing)."""
    _physics("boundary_viscosity_dropped")(monkeypatch)
    line = tiny.run(bench_json, cell)
    assert not line["correct"], line["checked"]


def test_reference_matches_the_program_per_step(bench_json):
    """Each reference against the program's CPU path on S0, one group
    after another: gaps at float32 rounding; in the tank, every boundary
    row in place with its volume within a tenth of ``check.VOLUME_RTOL``
    of the reference's V_b."""
    for cell in ("tiny_2d_v1.tiny_run", "tiny_3d.tiny_run", "tiny_3d_walls.tiny_run"):
        c = load_cell(cell, bench_json)
        s0 = inputs.start_state(c.scene, float(c.config["jitter"]), 99)
        prog = Program(c, torch.device("cpu"), harness.resort_every(c))
        st = prog.start(s0)
        host = s0
        wall = s0["material"] == 0  # by tag: a tag is a row of S0
        for _ in range(3):
            out = prog.advance(st, harness.resort_every(c))
            out_host = prog.to_host(out)
            ref = check.reference_steps(c, host, harness.resort_every(c),
                                        harness.resort_every(c), torch.device("cpu"))
            nums = check.compare(c, host, out_host, ref)
            assert nums["lost"] == 0
            assert max(nums[k] for k in ("rho_gap", "p_gap")) < 1e-4, nums
            assert max(nums[k] for k in ("dx_gap", "dv_gap")) < 0.5, nums
            if wall.any():
                n = int(out_host["num_active"])
                vb, volume = np.zeros(n), np.zeros(n)
                vb[host["object_id"][:n]] = ref["volume_b"].numpy()
                volume[out_host["object_id"][:n]] = out_host["volume"][:n]
                assert np.abs(volume[wall] / vb[wall] - 1.0).max() < check.VOLUME_RTOL / 10
            st, host = out, out_host
        assert np.isfinite(host["x"]).all()


def test_moved_or_resized_boundary_rows_are_lost(bench_json):
    """A boundary row moved by one float32 step, or carrying a volume off
    by twice the tolerance, counts in ``lost``; the fluid rows' numbers do
    not see boundary rows."""
    c = load_cell("tiny_3d_walls.tiny_run", bench_json)
    s0 = inputs.start_state(c.scene, float(c.config["jitter"]), 5)
    prog = Program(c, torch.device("cpu"), harness.resort_every(c))
    out = prog.to_host(prog.advance(prog.start(s0), 2))
    ref = check.reference_steps(c, s0, 2, 2, torch.device("cpu"))
    good = check.compare(c, s0, out, ref)
    assert good["lost"] == 0
    n = int(out["num_active"])
    walls = np.flatnonzero(out["material"][:n] == 0)
    moved = {k: v.copy() for k, v in out.items()}
    moved["x"][walls[:3], 1] = np.nextafter(moved["x"][walls[:3], 1], np.float32(1))
    moved["volume"][walls[5]] *= 1.0 + 2 * check.VOLUME_RTOL
    bad = check.compare(c, s0, moved, ref)
    assert bad["lost"] == 4
    assert {k: bad[k] for k in ("dx_gap", "dv_gap", "rho_gap", "p_gap", "tie_share")} == {
        k: good[k] for k in ("dx_gap", "dv_gap", "rho_gap", "p_gap", "tie_share")}
