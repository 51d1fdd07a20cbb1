"""Port config parity: every scene file parses to the same field values as
tisph_tpu.config, the compat presets resolve to equal SolverParams, and
scenes with rigid bodies or emitters are refused (not silently dropped)."""

import dataclasses
import glob
import json
import os

import pytest
import torch

import tisph_tpu as tt
from tisph_tpu.config import SolverParams

import tisph_tpu_torch as pt
from tisph_tpu_torch.config import SolverParams as PtSolverParams

torch.set_num_threads(2)

SCENES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "scenes", "*.json")))
COMPAT = ["reference", "config", "reference-exact"]


def _raw(path):
    with open(path) as f:
        return json.load(f)


def _unsupported(raw):
    return bool(raw.get("rigidBodies")) or bool(raw.get("emitters"))


@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_scene_fields_match_jax(path):
    raw = _raw(path)
    if _unsupported(raw):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pt.load_scene(path)
        return
    ref = dataclasses.asdict(tt.load_scene(path))
    assert ref.pop("rigid_bodies") == () and ref.pop("emitters") == ()
    assert dataclasses.asdict(pt.load_scene(path)) == ref


@pytest.mark.parametrize("compat", COMPAT)
@pytest.mark.parametrize("path", [p for p in SCENES if not _unsupported(_raw(p))],
                         ids=os.path.basename)
def test_solver_params_match_jax(path, compat):
    ref = SolverParams.from_scene(tt.load_scene(path), compat)
    got = PtSolverParams.from_scene(pt.load_scene(path), compat)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_unknown_compat_rejected():
    scene = pt.load_scene(os.path.join(os.path.dirname(__file__), "..", "scenes",
                                       "demo_2d.json"))
    with pytest.raises(ValueError):
        PtSolverParams.from_scene(scene, "exact")


@pytest.mark.parametrize("key", ["rigidBodies", "emitters"])
def test_unported_bodies_raise(key):
    raw = {"configuration": {"dim": 2}, "fluidBlocks": [],
           key: [{"geometryFile": "x.obj", "start": [0, 0], "end": [1, 1]}]}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.scene_from_dict(raw)
