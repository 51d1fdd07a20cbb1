"""Rigid bodies in the benchmark on the CPU: the voxelizer and the body
rows of S0 as the program makes them, the tags, the plain coupled
reference against ``WCSPHRigid``, the check's matching of body rows, and
the coupled step's bound."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs, voxels, work
from benchmark.cells import load_cell
from benchmark.program import Program
from benchmark.tests import tiny

SCENES = tiny.REPO / "scenes"
RIGID = tiny.TINY_SCENES["tiny_3d_rigid"][1]
# placements of scenes/assets/sphere.obj: (scale, translation, angle, axis)
PLACED = [([0.12] * 3, [1.0, 0.9, 0.5], 0.0, [0, 1, 0]),
          ([0.05, 0.07, 0.03], [0.3, 0.2, 0.25], 0.0, [0, 1, 0]),
          ([0.04] * 3, [0.2, 0.165, 0.2], 30.0, [1, 0, 1]),
          ([0.09, 0.05, 0.06], [0.61, 0.37, 0.44], -117.0, [0.3, -1.0, 0.2])]


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("pitch", [0.025, 0.02, 0.0133])
@pytest.mark.parametrize("placed", PLACED)
def test_voxels_as_the_program_makes_them(placed, pitch):
    """The benchmark's voxelizer gives the program's body rows bitwise, in
    the same order, scaled, turned and moved."""
    from tisph_tpu_torch.geometry.mesh import load_obj
    from tisph_tpu_torch.geometry.voxelize import voxelize_points

    scale, move, angle, axis = placed
    body = {"geometryFile": "assets/sphere.obj", "scale": scale, "translation": move,
            "rotationAngle": angle, "rotationAxis": axis}
    mesh = load_obj(SCENES / "assets" / "sphere.obj").apply_scale(scale)
    if angle:
        mesh.apply_rotation(angle, axis)
    ours = voxels.body_points(body, pitch, SCENES)
    theirs = voxelize_points(mesh.apply_translation(move), pitch)
    assert ours.dtype == np.float32 and ours.shape[0] > 20
    assert np.array_equal(ours, theirs)


def test_an_open_mesh_is_refused(tmp_path):
    verts, tris = voxels.read_obj(SCENES / "assets" / "sphere.obj")
    (tmp_path / "open.obj").write_text(
        "".join(f"v {a} {b} {c}\n" for a, b, c in verts)
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in tris[1:]))
    with pytest.raises(ValueError, match="closed meshes"):
        voxels.body_points({"geometryFile": "open.obj", "scale": [0.1] * 3}, 0.02, tmp_path)


def test_bodies_as_the_program_builds_them():
    """A static body listed before a dynamic one: every row of the
    benchmark's lattice is ``build_state``'s, the bodies first; the
    dynamic body's rows carry its index, every other row its start row
    plus the number of bodies, which is no body's index; the seed moves
    fluid rows only."""
    import tisph_tpu_torch as tt

    lat = inputs.lattice(RIGID, SCENES)
    st = tt.build_state(tt.scene_from_dict(RIGID, base_dir=str(SCENES)), device="cpu")
    n = int(lat["num_active"])
    assert st.num_active == n
    for k in ("x", "v", "density", "pressure", "mass", "volume", "material", "color"):
        assert np.array_equal(getattr(st, k)[:n].numpy(), lat[k]), k
    oid = st.object_id[:n].numpy()
    static, dynamic = oid == 0, oid == 1  # the program's body indices
    assert static.sum() > 0 and dynamic.sum() > 0 and np.flatnonzero(static).max() < \
        np.flatnonzero(dynamic).min() and (lat["material"][static | dynamic] == 0).all()
    assert (lat["object_id"][dynamic] == 1).all()
    assert np.array_equal(lat["object_id"][~dynamic], np.flatnonzero(~dynamic) + 2)
    assert inputs.dynamic_bodies(RIGID) == [1]
    s0 = inputs.start_state(RIGID, 0.01, 2 ** 33 + 1, SCENES)
    fluid = lat["material"] == 1
    assert np.array_equal(s0["x"][~fluid], lat["x"][~fluid])
    assert (s0["x"][fluid] != lat["x"][fluid]).any()


def test_tags_without_bodies_are_start_rows():
    for name in ("tiny_3d", "tiny_3d_walls", "tiny_2d_v1"):
        lat = inputs.lattice(tiny.TINY_SCENES[name][1])
        assert np.array_equal(lat["object_id"], np.arange(int(lat["num_active"])))


def test_the_voxelizer_stays_out_of_a_scene_without_bodies():
    """Making S0 of a scene without bodies, and the check's modules, load
    neither ``benchmark.voxels`` nor scipy: the cells' set-up pays nothing."""
    code = ("import sys, json\nfrom benchmark import inputs, check, harness\n"
            "from benchmark.tests import tiny\n"
            "for name in ('tiny_3d', 'tiny_3d_walls'):\n"
            "    inputs.start_state(tiny.TINY_SCENES[name][1], 0.01, 3)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.startswith(('scipy', "
            "'benchmark.voxels')))))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                       text=True, timeout=300, check=True)
    assert json.loads(p.stdout.splitlines()[-1]) == []


def _groups(bench_json, fault=None, seed=99, groups=3):
    """The program's groups from S0 on the tiny coupled cell, each judged
    against the reference from the program's state one group earlier."""
    c = load_cell("tiny_3d_rigid.tiny_run", bench_json)
    R = harness.resort_every(c)
    s0 = inputs.start_state(c.scene, float(c.config["jitter"]), seed, c.scene_path.parent)
    prog = Program(c, torch.device("cpu"), R, fault=fault)
    carry, host = prog.start(s0), s0
    for _ in range(groups):
        out = prog.advance(carry, R)
        out_host = prog.to_host(out)
        ref = check.reference_steps(c, host, R, R, torch.device("cpu"))
        yield c, host, out_host, ref, check.compare(c, host, out_host, ref)
        carry, host = out, out_host


# one group of the program against the float64 reference: float32 rounding
# of the state (the COM at the start: the program's float32 sum, 0.06 of
# the unit); the reactions scaled by 0.9 read above 1 in every body number
# but the spin, and above 0.2 there
TOL = {"dx_gap": 0.5, "dv_gap": 0.5, "rho_gap": 1e-4, "p_gap": 1e-4, "lost": 0.0,
       "body_dx_gap": 0.5, "body_dv_gap": 0.01, "body_w_gap": 0.01}


def test_reference_follows_the_coupled_program(bench_json):
    for _, _, out, ref, nums in _groups(bench_json):
        assert all(nums[k] <= t for k, t in TOL.items()), nums
        assert np.isfinite(ref["rigid_omega"].numpy()).all()
    assert np.abs(out["rigid_omega"]).max() > 0.1 and np.abs(out["rigid_v_com"]).max() > 0.1


def test_the_body_fault_reads_over_the_tolerance(bench_json):
    for *_, nums in _groups(bench_json, fault="reactions_scaled"):
        assert nums["body_dx_gap"] > 1 and nums["body_dv_gap"] > 1, nums
        assert nums["body_w_gap"] > 0.2, nums


def test_body_rows_are_matched_by_position(bench_json):
    """The reference's own answer read as the program's: its body rows in
    any order read ``lost`` 0 and gaps 0; a row dropped or repeated reads
    ``lost`` 1; the body and its COM moved by a distance read it in
    ``body_dx_gap``'s units."""
    c, host, _, ref, _ = next(_groups(bench_json, groups=1))
    own = check.as_answer(ref, host)
    body = np.flatnonzero(own["object_id"] == 1)
    units = check.compare(c, host, own, ref)
    assert units["lost"] == 0 and units["body_dx_gap"] == units["body_dv_gap"] == 0.0

    def edited(rows, shift=0.0):
        out = {k: (np.array(v) if k != "num_active" else v) for k, v in own.items()}
        for k in ("x", "v", "density", "pressure", "mass", "volume", "material",
                  "object_id"):
            out[k] = out[k][rows]
        out["num_active"] = np.asarray(len(rows))
        out["x"][out["object_id"] == 1] += shift
        out["rigid_com"] = out["rigid_com"] + shift
        return out

    rows = np.arange(int(own["num_active"]))
    permuted = rows.copy()
    permuted[body] = np.random.default_rng(3).permutation(body)
    assert check.compare(c, host, edited(permuted), ref) == units
    assert check.compare(c, host, edited(np.delete(rows, body[4])), ref)["lost"] == 1
    assert check.compare(c, host, edited(np.insert(rows, 0, body[7])), ref)["lost"] == 1
    d = 0.1 * 2 * float(c.scene["configuration"]["particleRadius"])
    moved = check.compare(c, host, edited(rows, np.asarray([0.0, d, 0.0])), ref)
    steps, g = int(ref["steps"]), 9.81
    assert moved["lost"] == 0
    assert moved["body_dx_gap"] == pytest.approx(d / (g * 2e-4 ** 2 * steps * (steps + 1) / 2))


def test_the_body_numbers_come_only_with_a_dynamic_body(bench_json):
    c = load_cell("tiny_3d_walls.tiny_run", bench_json)
    s0 = inputs.start_state(c.scene, float(c.config["jitter"]), 5)
    ref = check.reference_steps(c, s0, 2, 2, torch.device("cpu"))
    assert tuple(check.compare(c, s0, check.as_answer(ref, s0), ref)) == check.NUMBERS
    limits = {"dx_gap": 1.0, "body_dx_gap": 1.0}
    assert check.verdict({"dx_gap": 0.5, "body_dx_gap": 0.5, "body_w_gap": 9.0}, limits)
    assert not check.verdict({"dx_gap": 0.5}, limits)


def test_the_coupled_bound():
    """``rigid`` adds bvol every step, the reactions' pairs to the force,
    and the bodies' passes; ``wcsph`` with the same pairs lacks them."""
    pairs = {"with_self": 2.0e7, "fluid": 0, "live": 0, "boundary_with_self": 3.0e5}
    base = work.step_bound_ms("wcsph", 3, 60672, 60192, 48000, 2, pairs)
    b = work.step_bound_ms("rigid", 3, 60672, 60192, 48000, 2, pairs, bodies=1)
    assert set(b) == set(base) - {"force"} | {"force_react", "bvol", "bodies"}
    assert b["force_react"] == pytest.approx((2.0e7 * 60 + 3.0e5 * 52) / 67e12 * 1e3)
    assert b["bodies"] == pytest.approx(60672 * work.BODY_BYTES_PER_ROW[3] / 3.35e12 * 1e3)
    assert b["bvol"] > 0 and sum(b.values()) > sum(base.values())
    assert work.BODY_BYTES_PER_ROW == {2: 62, 3: 86}


def test_boundary_pairs_match_brute_force():
    s0 = inputs.start_state(RIGID, 0.01, 2 ** 31 + 5, SCENES)
    x, mat = s0["x"].astype(np.float64), s0["material"]
    near = ((x[:, None] - x[None]) ** 2).sum(-1) < 0.04 ** 2
    got = work.count_pairs(torch.from_numpy(s0["x"]), torch.from_numpy(mat), 0.04,
                           [0.0] * 3, [0.4] * 3, boundary=True)
    assert got["boundary_with_self"] == int(near[mat == 0].sum()) > 0
    assert got["with_self"] == int(near[mat == 1].sum())
