"""The port's copies of the 2D BPA chain (utils/dsu.py, utils/lines.py,
render/bpa2d.py and the native host library) against tisph_tpu's: the
cases of tests/test_aux.py's TestClustering, TestBPA2D and
test_domain_wireframe, each holding the port's output equal to the JAX
package's, with the native library and with the numpy fallback; and
run_scene --bpa.
"""

import json

import numpy as np
import pytest

from tisph_tpu.render import bpa2d as jbpa
from tisph_tpu.utils import dsu as jdsu
from tisph_tpu.utils.lines import domain_wireframe as jwire

from tisph_tpu_torch import run_scene
from tisph_tpu_torch.native import loader
from tisph_tpu_torch.render import bpa2d as pbpa
from tisph_tpu_torch.utils import DSU, cluster_points, domain_wireframe


def _circle_points(n=12, cx=50.0, cy=50.0, r=30.0):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def _canon(groups):
    return sorted(tuple(sorted(g)) for g in groups)


def _same_boundary(a, b):
    assert len(a.loops) == len(b.loops)
    assert all(np.array_equal(x, y) for x, y in zip(a.loops, b.loops))
    assert np.array_equal(a.edges, b.edges) and np.array_equal(a.points, b.points)
    fa, fb = a.triangle_fans(), b.triangle_fans()
    assert len(fa) == len(fb) and all(np.array_equal(x, y) for x, y in zip(fa, fb))


def test_native_library_builds_outside_the_sources():
    lib = loader.load()
    assert lib is not None
    assert "build" in loader._LIB.split("/") and loader._LIB.endswith("libsph_native.so")


class TestClustering:
    @pytest.mark.parametrize("native", [True, False])
    def test_two_groups(self, native):
        pts = np.concatenate([_circle_points(), _circle_points(cx=400.0)])
        groups = cluster_points(pts, 50.0, use_native=native)
        assert sorted(len(g) for g in groups) == [12, 12]
        assert groups == jdsu.cluster_points(pts, 50.0, use_native=native)

    def test_native_matches_numpy(self):
        pts = np.random.default_rng(0).uniform(0, 10, size=(300, 2))
        g_native = cluster_points(pts, 0.7, use_native=True)
        g_numpy = cluster_points(pts, 0.7, use_native=False)
        assert _canon(g_native) == _canon(g_numpy)
        assert g_native == jdsu.cluster_points(pts, 0.7, use_native=True)
        assert g_numpy == jdsu.cluster_points(pts, 0.7, use_native=False)

    def test_dsu_basic(self):
        d, j = DSU(5), jdsu.DSU(5)
        for a, b in ((0, 1), (3, 4)):
            d.union(a, b)
            j.union(a, b)
        assert d.find(0) == d.find(1) and d.find(0) != d.find(3)
        assert sorted(len(g) for g in d.groups()) == [1, 2, 2]
        assert _canon(d.groups()) == _canon(j.groups())


class TestBPA2D:
    def test_circle_boundary(self):
        """The reference's 12-point circle demo: the walk visits all 12
        points, as in the JAX package."""
        b = pbpa.extract_boundary_2d(_circle_points(), radius=50.0)
        assert len(b.loops) == 1 and len(b.loops[0]) == 12
        assert b.edges.shape == (11, 2) and b.triangle_fans()[0].shape == (10, 3)
        _same_boundary(b, jbpa.extract_boundary_2d(_circle_points(), radius=50.0))

    @pytest.mark.parametrize("native", [True, False])
    def test_two_blobs(self, native):
        pts = np.concatenate([_circle_points(), _circle_points(cx=400.0)])
        b = pbpa.extract_boundary_2d(pts, radius=50.0, use_native=native)
        assert len(b.loops) == 2
        _same_boundary(b, jbpa.extract_boundary_2d(pts, radius=50.0, use_native=native))

    @pytest.mark.parametrize("native", [True, False])
    def test_fluid_lattice(self, native):
        """A jittered dam-break lattice large enough for the surface filter
        and the bounded walk: the same loops, edges and fans."""
        rng = np.random.default_rng(3)
        g = np.stack(np.meshgrid(np.arange(0.1, 0.9, 0.01), np.arange(0.1, 0.5, 0.01),
                                 indexing="ij"), -1).reshape(-1, 2)
        pts = (g + rng.normal(0, 1e-3, g.shape)).astype(np.float32)[:, :2]
        b = pbpa.extract_boundary_2d(pts, radius=0.03, use_native=native)
        assert len(b.loops) >= 1 and b.edges.shape[0] > 100
        _same_boundary(b, jbpa.extract_boundary_2d(pts, radius=0.03, use_native=native))


def test_domain_wireframe():
    pts, edges = domain_wireframe([0, 0, 0], [5, 3, 2])
    assert pts.shape == (8, 3) and edges.shape == (12, 2)
    lengths = np.linalg.norm(pts[edges[:, 0]] - pts[edges[:, 1]], axis=1)
    assert sorted(np.unique(np.round(lengths, 5)).tolist()) == [2.0, 3.0, 5.0]
    for lo, hi in (([0, 0, 0], [5, 3, 2]), ([0, 0], [5, 3])):
        p, e = domain_wireframe(lo, hi)
        jp, je = jwire(lo, hi)
        assert np.array_equal(p, jp) and np.array_equal(e, je)


def test_run_scene_bpa(tmp_path, capsys):
    """run_scene --bpa writes boundary.bpa.npz: the keys of
    examples/run_scene.py's file, and the JAX package's boundary of the
    same final fluid."""
    raw = json.loads(open("scenes/demo_2d.json").read())
    raw["configuration"]["particleRadius"] = 0.03
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(raw))
    out = tmp_path / "out"
    rc = run_scene.main([str(path), "--steps", "1", "--substeps", "2", "--metrics-every", "0",
                         "--device", "cpu", "--out", str(out), "--bpa"])
    assert rc == 0
    assert "BPA boundary:" in capsys.readouterr().out
    with np.load(out / "boundary.bpa.npz") as z:
        assert set(z.files) == {"points", "edges", "loop_sizes", "loops"}
        want = jbpa.extract_boundary_2d(z["points"], radius=3.0 * 0.03)
        assert np.array_equal(z["edges"], want.edges)
        assert np.array_equal(z["loops"], np.concatenate(want.loops))
        assert z["loop_sizes"].sum() == len(z["loops"])
