"""The port's viewers, GIF assembly, 3D BPA guards, debug and profiling
utilities, run_scene's view options and the demo, on the CPU, against the
JAX package's behaviour:

- tests/test_debug.py's five cases on the port, and validate_state's
  messages equal to tisph_tpu's on the same clean, NaN, escaped and
  miscounted states;
- tests/test_aux.py's TestOrbitViewer cases headless, and the orbit and
  flat viewers' projected frames array-equal to tisph_tpu's on the same
  host state;
- frames_to_gif on three PNGs, the bpa3d guards raising as tisph_tpu's do;
- run_scene --out --format png --gif --view --view-every 2 on
  scenes/demo_2d.json and python -m tisph_tpu_torch.demo --frames 2 --out.
"""

import dataclasses
import os

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import tisph_tpu as tt  # noqa: E402
from tisph_tpu.models.state import state_to_host as jax_to_host  # noqa: E402
from tisph_tpu.render import bpa3d as jax_bpa3d  # noqa: E402
from tisph_tpu.render import orbit as jax_orbit  # noqa: E402
from tisph_tpu.render import viewer as jax_viewer  # noqa: E402
from tisph_tpu.utils import debug as jax_debug  # noqa: E402
from tisph_tpu.utils import profiling as jax_profiling  # noqa: E402

import tisph_tpu_torch as pt  # noqa: E402
from tisph_tpu_torch import demo, run_scene  # noqa: E402
from tisph_tpu_torch.render import bpa3d, orbit, video, viewer  # noqa: E402
from tisph_tpu_torch.utils import debug, profiling  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_2D = os.path.join(REPO, "scenes", "demo_2d.json")


@pytest.fixture(scope="module")
def bound():
    """scenes/demo_2d.json bound on each package, the port's from the JAX
    state's host copy."""
    scene = tt.load_scene(DEMO_2D)
    solver = tt.WCSPH(scene)
    state = solver.bind(tt.build_state(scene))
    port = pt.WCSPH(pt.load_scene(DEMO_2D), device="cpu")
    return solver, state, port, pt.state_from_host(jax_to_host(state), "cpu")


def _spoil(jstate, pstate, field, row, col, value):
    j = dataclasses.replace(jstate, **{field: getattr(jstate, field).at[row, col].set(value)})
    t = getattr(pstate, field).clone()
    t[row, col] = value
    return j, dataclasses.replace(pstate, **{field: t})


def test_validate_clean_state(bound):
    _, _, port, state = bound
    assert debug.validate_state(state, port.params, strict=False) == []


def test_validate_catches_nan(bound):
    _, _, port, state = bound
    bad = dataclasses.replace(state, x=state.x.clone())
    bad.x[0, 0] = float("nan")
    problems = debug.validate_state(bad, port.params, strict=False)
    assert any("non-finite positions" in p for p in problems)
    with pytest.raises(AssertionError):
        debug.validate_state(bad, port.params, strict=True)


def test_validate_catches_escape(bound):
    _, _, port, state = bound
    bad = dataclasses.replace(state, x=state.x.clone())
    bad.x[0, 0] = 99.0
    problems = debug.validate_state(bad, port.params, strict=False)
    assert any("outside the domain" in p for p in problems)


@pytest.mark.parametrize("case", ["clean", "nan_x", "nan_v", "escape", "mass", "count"])
def test_validate_messages_match_jax(bound, case):
    solver, jstate, port, pstate = bound
    if case == "nan_x":
        jstate, pstate = _spoil(jstate, pstate, "x", 3, 1, float("nan"))
    elif case == "nan_v":
        jstate, pstate = _spoil(jstate, pstate, "v", 5, 0, float("inf"))
    elif case == "escape":
        jstate, pstate = _spoil(jstate, pstate, "x", 0, 0, 99.0)
    elif case == "mass":
        jstate = dataclasses.replace(jstate, mass=jstate.mass.at[7].set(0.0))
        m = pstate.mass.clone()
        m[7] = 0.0
        pstate = dataclasses.replace(pstate, mass=m)
    elif case == "count":
        jstate = dataclasses.replace(jstate, num_active=jnp.asarray(int(jstate.num_active) - 1))
        pstate = dataclasses.replace(pstate, num_active=pstate.num_active - 1)
    want = jax_debug.validate_state(jstate, solver.params, strict=False)
    got = debug.validate_state(pstate, port.params, strict=False)
    assert got == want
    assert (case == "clean") == (got == [])


def test_checked_step_clean(bound):
    _, _, port, state = bound
    out = debug.checked_step(port.step, port.params)(state)
    assert np.isfinite(out.x.numpy()).all()


def test_checked_step_detects_nan(bound):
    _, _, port, state = bound
    bad = dataclasses.replace(state, v=state.v.clone())
    bad.v[5, 0] = float("nan")
    with pytest.raises(RuntimeError, match="non-finite"):
        debug.checked_step(port.step, port.params)(bad)


def test_step_timer_trace_and_throughput(bound, tmp_path):
    _, _, port, state = bound
    timer = profiling.StepTimer()
    for _ in range(2):
        with timer("step", result=state):
            state = port.step(state)
    timer.add("io", 0.5)
    s = timer.summary()
    assert s["step"]["count"] == 2 and s["step"]["total_s"] > 0
    assert s["io"] == {"total_s": 0.5, "count": 1, "mean_ms": 500.0}
    names = [line.split()[0] for line in timer.report().splitlines()]
    assert names == sorted(s, key=lambda k: -s[k]["total_s"])  # costliest first
    with profiling.trace(str(tmp_path / "tr")) as prof:
        port.step(state)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert len(prof.key_averages()) > 0
    assert profiling.throughput(1000, 50, 2.0) == jax_profiling.throughput(1000, 50, 2.0)


class TestOrbitViewer:
    """tests/test_aux.py::TestOrbitViewer on the port's render.orbit."""

    RAW = {
        "configuration": {
            "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [2, 1, 1],
            "particleRadius": 0.05, "density0": 1000,
            "gravitation": [0, -9.81, 0], "c_s": 50.0,
        },
        "fluidBlocks": [{"start": [0.1, 0.1, 0.1], "end": [0.5, 0.5, 0.5],
                         "velocity": [0, 0, 0], "density": 1000.0,
                         "color": [50, 100, 200]}],
        "rigidBodies": [],
    }

    def test_from_lookat_roundtrip(self):
        cam = orbit.OrbitCamera.from_lookat((5.5, 2.5, 4.0), (-1.0, 0.0, 0.0))
        np.testing.assert_allclose(cam.position, [5.5, 2.5, 4.0], atol=1e-9)
        np.testing.assert_allclose(cam.target, [-1.0, 0.0, 0.0], atol=1e-9)

    def test_projection_geometry(self):
        cam = orbit.OrbitCamera(target=[0, 0, 0], distance=2.0, azimuth=0.0,
                                elevation=0.0, fov=90.0)
        pts = np.array([[0, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [5, 0, 0]])
        xy, z, vis = cam.project(pts)
        np.testing.assert_allclose(xy[0], [0, 0], atol=1e-12)
        np.testing.assert_allclose(z[0], 2.0, atol=1e-12)
        assert xy[1][1] > 0 and abs(xy[1][0]) < 1e-12
        assert abs(xy[2][1]) < 1e-12 and abs(abs(xy[2][0]) - 0.25) < 1e-9
        assert not vis[3]
        assert vis[:3].all()

    def test_orbit_pan_dolly_move(self):
        cam = orbit.OrbitCamera(target=[1, 1, 1], distance=3.0, azimuth=10.0, elevation=30.0)
        p0 = cam.position.copy()
        cam.orbit(15.0, -10.0)
        assert cam.azimuth == 25.0 and cam.elevation == 20.0
        np.testing.assert_allclose(np.linalg.norm(cam.position - cam.target), 3.0, atol=1e-9)
        cam.orbit(0.0, -200.0)
        assert cam.elevation == -89.0
        cam.dolly(2.0)
        assert cam.distance < 3.0
        t0 = cam.target.copy()
        assert cam.move("w") and not cam.move("x")
        assert np.linalg.norm(cam.target - t0) > 0
        cam.reset()
        np.testing.assert_allclose(cam.position, p0, atol=1e-9)
        assert cam.distance == 3.0

    def test_headless_render_and_events(self, tmp_path):
        v = orbit.OrbitViewer(pt.scene_from_dict(self.RAW), interactive=False, max_points=500)
        rng = np.random.default_rng(0)
        x = rng.uniform([0, 0, 0], [2, 1, 1], size=(2000, 3))
        colors = rng.uniform(size=(2000, 3))
        xy, rgba, sizes = v.render_frame(x, colors)
        assert 0 < len(xy) <= 500
        assert np.isfinite(xy).all() and np.isfinite(sizes).all()
        assert (rgba >= 0).all() and (rgba <= 1).all()

        class Ev:
            def __init__(self, x=None, y=None, button=1, key=None, step=0):
                self.x, self.y, self.button, self.key, self.step = x, y, button, key, step

        az0 = v.camera.azimuth
        v._last = (x, colors)
        v._on_press(Ev(x=100, y=100))
        v._on_motion(Ev(x=150, y=100))
        assert v.camera.azimuth != az0
        d0 = v.camera.distance
        v._on_scroll(Ev(step=1))
        assert v.camera.distance < d0
        t0 = v.camera.target.copy()
        v._on_press(Ev(x=100, y=100, button=3))
        v._on_motion(Ev(x=120, y=130, button=3))
        assert np.linalg.norm(v.camera.target - t0) > 0
        v._on_key(Ev(key="r"))
        assert v.camera.distance == d0 or v.camera.azimuth == az0
        out = tmp_path / "orbit.png"
        v.savefig(str(out))
        assert out.stat().st_size > 1000
        v.close()

    def test_projection_equals_jax_on_the_same_state(self):
        """The same host state through both packages' OrbitViewer.show:
        the same points, projections, colours and sizes, array-equal."""
        jscene = tt.scene_from_dict(self.RAW)
        jstate = tt.build_state(jscene)
        rng = np.random.default_rng(1)
        jstate = dataclasses.replace(jstate, x=jstate.x + jnp.asarray(
            rng.normal(scale=0.02, size=jstate.x.shape).astype(np.float32)))
        pstate = pt.state_from_host(jax_to_host(jstate), "cpu")
        jv = jax_orbit.OrbitViewer(jscene, interactive=False)
        pv = orbit.OrbitViewer(pt.scene_from_dict(self.RAW), interactive=False)
        jv.camera.orbit(20.0, 5.0)
        pv.camera.orbit(20.0, 5.0)
        jv.show(jstate)
        pv.show(pstate)
        for a, b in zip(pv._last, jv._last):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pv.render_frame(*pv._last), jv.render_frame(*jv._last)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pv.camera.project(pv._last[0]), jv.camera.project(jv._last[0])):
            np.testing.assert_array_equal(a, b)
        jv.close()
        pv.close()


@pytest.mark.parametrize("dim", [2, 3])
def test_flat_viewer_matches_jax(dim, tmp_path):
    raw = dict(TestOrbitViewer.RAW)
    if dim == 2:
        raw = {"configuration": dict(raw["configuration"], dim=2, domainStart=[0, 0],
                                     domainEnd=[2, 1], gravitation=[0, -9.81]),
               "fluidBlocks": [{"start": [0.1, 0.1], "end": [0.5, 0.5]}]}
    jscene = tt.scene_from_dict(raw)
    jstate = tt.build_state(jscene)
    pstate = pt.state_from_host(jax_to_host(jstate), "cpu")
    pv = viewer.Viewer(pt.scene_from_dict(raw), interactive=False)
    jv = jax_viewer.Viewer(jscene, interactive=False)
    pv.show(pstate, title="frame 0")
    jv.show(jstate, title="frame 0")
    np.testing.assert_array_equal(np.asarray(pv._scatter.get_offsets()),
                                  np.asarray(jv._scatter.get_offsets()))
    np.testing.assert_array_equal(pv._scatter.get_facecolors(), jv._scatter.get_facecolors())
    pv.savefig(str(tmp_path / "v.png"))
    assert (tmp_path / "v.png").stat().st_size > 1000
    pv.close()
    jv.close()


def test_frames_to_gif(tmp_path):
    from PIL import Image

    for k, c in enumerate(((255, 0, 0), (0, 255, 0), (0, 0, 255))):
        Image.new("RGB", (32, 24), c).save(tmp_path / f"frame_{k:06d}.png")
    out = video.frames_to_gif(str(tmp_path), str(tmp_path / "a.gif"), fps=10)
    with Image.open(out) as gif:
        assert gif.n_frames == 3 and gif.size == (32, 24)
    with pytest.raises(FileNotFoundError):
        video.frames_to_gif(str(tmp_path / "none"), str(tmp_path / "b.gif"))


def test_bpa3d_guards_raise_as_jax():
    pts = np.random.default_rng(0).uniform(size=(50, 3))
    for name, args in (("reconstruct_ball_pivoting", (pts, [0.1])),
                       ("reconstruct_marching_cubes", (pts, 0.05))):
        try:
            getattr(jax_bpa3d, name)(*args)
        except ImportError as e:
            want = str(e)
        else:
            pytest.skip("this machine has open3d or scikit-image")
        with pytest.raises(ImportError) as got:
            getattr(bpa3d, name)(*args)
        assert str(got.value) == want


def test_run_scene_view_gif(tmp_path, capsys):
    out = tmp_path / "frames"
    gif = tmp_path / "run.gif"
    rc = run_scene.main([DEMO_2D, "--steps", "3", "--substeps", "1", "--out", str(out),
                         "--format", "png", "--gif", str(gif), "--view", "--orbit",
                         "--view-every", "2", "--metrics-every", "0", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr()
    assert "GIF written to" in text.out and "--orbit is 3D-only" in text.err
    from PIL import Image

    assert sorted(os.listdir(out)) == [f"frame_{k:06d}.png" for k in range(3)]
    with Image.open(gif) as g:
        assert g.n_frames == 3
    with pytest.raises(SystemExit):
        run_scene.main([DEMO_2D, "--gif", str(gif), "--device", "cpu"])


def test_demo_writes_frames(tmp_path, capsys):
    assert demo.main(["--frames", "2", "--substeps", "2", "--out", str(tmp_path),
                      "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["demo_00000.png", "demo_00001.png"]
    assert "10310 particles on cpu" in capsys.readouterr().out
