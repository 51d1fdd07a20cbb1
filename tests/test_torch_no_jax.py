"""The PyTorch port imports neither jax nor the JAX package: run_scene on
the CPU, a fluid scene with a boundary block (on the seg and the linear
layout, and on the legacy solver with --bpa), a scene with a dynamic mesh
body (voxelizer and coupled solver) and a scene with an emitter (with
--checkpoint, then --resume); run_sharded on two CPU shards with each of
the three scenes (the plain, coupled and emitting sharded paths), on a
2x2 mesh of four CPU devices with each (the rectangle decomposition) and
on the linear layout; the
viewers, the GIF assembler, the 3D BPA guards, the debug and profiling
utilities, the demo, the subpackages' re-exported names and the CUDA
graph runner, in a fresh interpreter, leave both out of
sys.modules (tisph_tpu/__init__.py imports jax and every solver, so
importing any tisph_tpu module would pull jax in)."""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = r"""
import json, sys
import matplotlib
matplotlib.use("Agg")
import tisph_tpu_torch as tt
from tisph_tpu_torch import (bench, bench_ladder, checkpoint, demo, kernel_times, run_scene,
                             run_sharded)
from tisph_tpu_torch.parallel import (ShardedWCSPH, ShardedWCSPH2D, ShardedWCSPHRect, make_mesh,
                                      make_mesh2d, make_mesh3d)
from tisph_tpu_torch.geometry import TriMesh, build_state, cube_lattice, load_obj, voxelize_points
from tisph_tpu_torch.models import SimState, WCSPH, WCSPHLegacy
from tisph_tpu_torch.ops import cubic_kernel, cubic_kernel_grad, cubic_kernel_sigma, tait_pressure
from tisph_tpu_torch.models import graphs
from tisph_tpu_torch.render import bpa3d, orbit, video, viewer
from tisph_tpu_torch.utils import debug, profiling
from tisph_tpu_torch.tools import compare_compat, compare_resort, soak
from tisph_tpu_torch.version import __version__
import chip_smoke

for path in sys.argv[1:4]:
    rc = run_scene.main([path, "--steps", "2", "--substeps", "2", "--resort", "2",
                         "--metrics-every", "1", "--device", "cpu"])
    assert rc == 0, rc
rc = run_scene.main([sys.argv[1], "--steps", "2", "--substeps", "2", "--resort", "1",
                     "--layout", "linear", "--metrics-every", "1", "--device", "cpu"])
assert rc == 0, rc
rc = run_scene.main([sys.argv[1], "--steps", "1", "--substeps", "2", "--solver", "legacy",
                     "--bpa", "--out", sys.argv[4], "--metrics-every", "1", "--device", "cpu"])
assert rc == 0, rc
for extra in (["--checkpoint", sys.argv[5]], ["--resume", sys.argv[5]]):
    rc = run_scene.main([sys.argv[3], "--steps", "2", "--substeps", "3", "--resort", "2",
                         "--metrics-every", "1", "--device", "cpu"] + extra)
    assert rc == 0, rc
for path in sys.argv[1:4]:
    rc = run_sharded.main([path, "--devices", "cpu,cpu", "--steps", "2", "--resort", "2"])
    assert rc == 0, rc
    rc = run_sharded.main([path, "--mesh2d", "2x2", "--devices", "cpu,cpu,cpu,cpu", "--steps", "2",
                           "--resort", "2"])
    assert rc == 0, rc
rc = run_sharded.main([sys.argv[1], "--devices", "cpu,cpu", "--steps", "2", "--layout", "linear"])
assert rc == 0, rc
sc = tt.load_scene(sys.argv[1])
solver = tt.WCSPH(sc, device="cpu")
st = debug.checked_step(solver.step, solver.params)(solver.bind(tt.build_state(sc, device="cpu")))
assert debug.validate_state(st, solver.params) == []
v = orbit.OrbitViewer(tt.load_scene(sys.argv[2]), interactive=False)
v.show(tt.build_state(tt.load_scene(sys.argv[2]), device="cpu"))
v.close()
assert demo.main(["--frames", "1", "--substeps", "1", "--out", sys.argv[4], "--device", "cpu"]) == 0
video.frames_to_gif(sys.argv[4], sys.argv[4] + "/demo.gif", pattern="demo_*.png")
assert soak.main([sys.argv[1], "--steps", "2", "--chunk", "1", "--cpu"]) == 0
assert compare_resort.main([sys.argv[1], "--steps", "2", "--resort", "2", "--cpu", "--json"]) == 0
for solver in ("wcsph", "legacy"):
    assert compare_compat.main([sys.argv[1], "--solver", solver, "--frames", "1",
                                "--substeps", "2", "--cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tisph_tpu"))
print(json.dumps(bad))
"""


def test_port_imports_no_jax(tmp_path):
    scene = {
        "configuration": {
            "dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [1.0, 1.0],
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0.0, -9.81], "c_s": 50.0,
        },
        "boundaryBlocks": [{"start": [0.6, 0.1], "end": [0.8, 0.3]}],
        "fluidBlocks": [{"start": [0.15, 0.15], "end": [0.55, 0.55],
                         "velocity": [0.2, -1.0]}],
    }
    rigid = {
        "configuration": {
            "dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0], "c_s": 40.0,
        },
        "rigidBodies": [{"geometryFile": os.path.join(REPO, "scenes", "assets", "sphere.obj"),
                         "scale": [0.15] * 3, "translation": [0.5, 0.45, 0.5],
                         "density": 400.0, "isDynamic": True}],
        "fluidBlocks": [{"start": [0.2] * 3, "end": [0.8, 0.45, 0.8], "spacing": "diameter"}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(scene))
    rigid_path = tmp_path / "rigid.json"
    rigid_path.write_text(json.dumps(rigid))
    emit = dict(scene, emitters=[{"start": [0.6, 0.8], "end": [0.7, 0.8001],
                                  "velocity": [0.0, -1.0], "interval": 3, "maxParticles": 20}])
    emit_path = tmp_path / "emit.json"
    emit_path.write_text(json.dumps(emit))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _CODE, str(path), str(rigid_path), str(emit_path),
         str(tmp_path), str(tmp_path / "ck.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
