"""A copy of the benchmark's folder with tiny cells added by new files
only, for the CPU tests: a 2D scene on the V1 solver, two 3D scenes on
the V2 solver, the second in a tank of static boundary particles (a
floor and four walls, two layers each, and a box), and a 3D scene on the
coupled solver (``rigid``, reference ``v2_rigid``): a static sphere
listed before a dynamic one that a block of fluid rises against.  Each
runs under both traffic mixes cut to 20-step episodes, held to the
limits of the full-size cell of the same solver and mix; the coupled
scene, which has no full-size cell yet, to demo_3d's and to
:data:`BODY_LIMITS`."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

TINY_SCENES = {
    "tiny_2d_v1": ("demo_2d_v1", {
        "configuration": {"dim": 2, "domainStart": [0.0, 0.0], "domainEnd": [1.0, 1.0],
                          "particleRadius": 0.01, "density0": 1000,
                          "gravitation": [0.0, -9.81], "c_s": 88.5},
        "rigidBodies": [],
        "fluidBlocks": [{"start": [0.3, 0.1], "end": [0.5, 0.3], "velocity": [0.0, -2.0],
                         "density": 1000.0, "color": [50, 100, 200]}]}),
    "tiny_3d": ("demo_3d", {
        "configuration": {"dim": 3, "domainStart": [0.0, 0.0, 0.0],
                          "domainEnd": [1.0, 1.0, 0.6], "particleRadius": 0.01,
                          "density0": 1000, "gravitation": [0.0, -9.81, 0.0], "c_s": 88.5},
        "rigidBodies": [],
        "fluidBlocks": [{"start": [0.3, 0.1, 0.2], "end": [0.4, 0.2, 0.3],
                         "velocity": [0.0, -1.0, 5.0], "density": 1000.0,
                         "color": [50, 100, 200]}]}),
    "tiny_3d_walls": ("demo_3d", {
        "configuration": {"dim": 3, "domainStart": [0.0, 0.0, 0.0],
                          "domainEnd": [0.5, 0.5, 0.5], "particleRadius": 0.01,
                          "density0": 1000, "gravitation": [0.0, -9.81, 0.0], "c_s": 88.5},
        "boundaryBlocks": [
            {"start": [0.06, 0.06, 0.06], "end": [0.45, 0.099, 0.45]},
            {"start": [0.06, 0.1, 0.06], "end": [0.099, 0.3, 0.45]},
            {"start": [0.42, 0.1, 0.06], "end": [0.459, 0.3, 0.45]},
            {"start": [0.1, 0.1, 0.06], "end": [0.419, 0.3, 0.099]},
            {"start": [0.1, 0.1, 0.42], "end": [0.419, 0.3, 0.459]},
            {"start": [0.25, 0.1, 0.2], "end": [0.309, 0.159, 0.299], "color": [90, 90, 90]}],
        "fluidBlocks": [{"start": [0.11, 0.11, 0.11], "end": [0.21, 0.21, 0.3],
                         "velocity": [3.0, -1.0, 0.0], "density": 1000.0,
                         "color": [50, 100, 200]}]}),
    "tiny_3d_rigid": ("demo_3d", {
        "configuration": {"dim": 3, "domainStart": [0.0, 0.0, 0.0],
                          "domainEnd": [0.4, 0.4, 0.4], "particleRadius": 0.01,
                          "density0": 1000, "gravitation": [0.0, -9.81, 0.0], "c_s": 88.5},
        "rigidBodies": [
            {"geometryFile": "assets/sphere.obj", "scale": [0.02, 0.02, 0.02],
             "translation": [0.08, 0.08, 0.08], "color": [90, 90, 90]},
            {"geometryFile": "assets/sphere.obj", "scale": [0.04, 0.04, 0.04],
             "translation": [0.2, 0.165, 0.2], "rotationAngle": 30,
             "rotationAxis": [1.0, 0.0, 1.0], "density": 500.0, "color": [200, 120, 60],
             "isDynamic": True}],
        "fluidBlocks": [{"start": [0.14, 0.06, 0.14], "end": [0.26, 0.12, 0.26],
                         "velocity": [0.0, 0.5, 0.2], "density": 1000.0,
                         "color": [50, 100, 200]}]}),
}
# the scenes that hold boundary rows, and those with a dynamic body
WALLS = ("tiny_3d_walls",)
BODIES = ("tiny_3d_rigid",)
# what a coupled scene's configuration says beside its full-size one's
RIGID = {"solver": "rigid", "reference": "v2_rigid"}
# the body numbers' limits of the coupled tiny cells, lower^0.4 upper^0.6
# to one digit, from CPU readings over both mixes: the program's largest on
# 4 seeds (0.062, 0.0019, 0.0019), the least of the reactions scaled by 0.9
# on 2 (42, 44, 1.3) and of the control (454, 18, 7.2)
BODY_LIMITS = {"body_dx_gap": 2.0, "body_dv_gap": 0.5, "body_w_gap": 0.05}
MIXES = {"tiny_run": ("run", 8), "tiny_frames": ("frames", 5)}


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_copy(dest: Path) -> Path:
    """The repo's BENCHMARK.json and benchmark folder copied under
    ``dest``, plus the tiny cells; returns the copy's BENCHMARK.json."""
    root = dest / "benchmark"
    shutil.copytree(REPO / "benchmark", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "configs" / "assets").mkdir()
    shutil.copy(REPO / "scenes" / "assets" / "sphere.obj", root / "configs" / "assets")
    for name, (full, scene) in TINY_SCENES.items():
        _dump(root / "configs" / f"{name}.scene.json", scene)
        config = json.loads((root / "configs" / f"{full}.json").read_text())
        _dump(root / "configs" / f"{name}.json", config | {"name": name,
                                                           "scene": f"{name}.scene.json"}
              | (RIGID if name in BODIES else {}))
        bench["configs"].append({"name": name, "source": "a tiny scene for the CPU tests",
                                 "file": f"benchmark/configs/{name}.json", "reduced": [],
                                 "why": "CPU tests"})
    for mix, (full, chunk) in MIXES.items():
        traffic = json.loads((root / "traffic" / f"{full}.json").read_text())
        _dump(root / "traffic" / f"{mix}.json", traffic | {"episode_steps": 20,
                                                           "chunk_steps": chunk})
    for name, (full_cfg, _) in TINY_SCENES.items():
        for mix, (full_mix, _) in MIXES.items():
            cell = f"{name}.{mix}"
            bench["workloads"].append({"name": cell, "config": name, "traffic": mix,
                                       "chips": 1, "why": "CPU tests"})
            limits = json.loads((root / "limits" / f"{full_cfg}.{full_mix}.json").read_text())
            if name in BODIES:
                limits["limits"] |= BODY_LIMITS
            _dump(root / "limits" / f"{cell}.json", limits)
            for m in bench["end_to_end"] + bench["per_layer"]:
                if f"{full_cfg}.{full_mix}" in m.get("workloads", ()):
                    m["workloads"].append(cell)
    path = dest / "BENCHMARK.json"
    _dump(path, bench)
    return path


def run(bench_json: Path, cell: str, seed: int = 12345678901, seconds: float = 0.5) -> dict:
    """One run of a tiny cell on the CPU, skipping the harness's look for
    a card (the CPU tests' only way in)."""
    import time

    from benchmark.cells import load_cell
    from benchmark.run import run_cell

    return run_cell(load_cell(cell, bench_json), seed, seconds, False, torch.device("cpu"),
                    time.perf_counter(), log=lambda s: None)
