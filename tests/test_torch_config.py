"""Port config parity: every scene file parses to the same field values as
tisph_tpu.config (rigid bodies and emitters included) with the same
domain_size, and the compat presets resolve to equal SolverParams."""

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


def _fields_match(got, ref):
    """The port's SceneConfig equals tisph_tpu's field by field."""
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_scene_fields_match_jax(path):
    _fields_match(pt.load_scene(path), tt.load_scene(path))
    if _raw(path).get("emitters"):
        assert pt.load_scene(path).emitters


@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
def test_domain_size_matches_jax(path):
    got, ref = pt.load_scene(path).domain_size, tt.load_scene(path).domain_size
    assert type(got) is tuple and len(got) == len(ref)
    assert got == ref


@pytest.mark.parametrize("compat", COMPAT)
@pytest.mark.parametrize("path", SCENES, ids=os.path.basename)
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
def test_bodies_and_emitters_match_jax(key):
    """Rigid bodies and emitters parse to tisph_tpu's fields: a minimal
    entry with every default, then a static obstacle with every key, or an
    emitter with every key in a 3-element domain."""
    raw = {"configuration": {"dim": 2}, "fluidBlocks": [],
           key: [{"geometryFile": "x.obj", "start": [0, 0], "end": [1, 1]}]}
    _fields_match(pt.scene_from_dict(raw), tt.scene_from_dict(raw))
    if key == "emitters":
        raw = {"configuration": {"dim": 3, "particleRadius": 0.02}, "fluidBlocks": [],
               key: [{"start": [0.1, 0.8, 0.2], "end": [0.3, 0.8001, 0.4],
                      "velocity": [0, -2, 0], "interval": 0, "density": 900,
                      "color": [10, 20, 30], "maxParticles": 120}]}
        got = pt.scene_from_dict(raw)
        _fields_match(got, tt.scene_from_dict(raw))
        assert got.emitters[0].max_particles == 120 and got.emitters[0].color[0] < 1
        return
    raw = {"configuration": {"dim": 3, "particleRadius": 0.02}, "fluidBlocks": [],
           key: [{"geometryFile": "assets/sphere.obj", "scale": [0.1, 0.2, 0.3],
                  "translation": [0.5, 0.4, 0.5], "rotationAngle": 30,
                  "rotationAxis": [1, 0, 1], "velocity": [0.5, 0, 0], "density": 700,
                  "color": [10, 20, 30], "isDynamic": False}]}
    got = pt.scene_from_dict(raw, base_dir="scenes")
    _fields_match(got, tt.scene_from_dict(raw, base_dir="scenes"))
    assert got.rigid_bodies[0].rotation_angle == 30.0 and not got.rigid_bodies[0].is_dynamic


_SHORT = {
    "fluidBlocks": {"start": [0.1, 0.1], "end": [0.5, 0.5, 0.5]},
    "boundaryBlocks": {"start": [0.6, 0.1, 0.1], "end": [0.8, 0.3]},
    "emitters": {"start": [0.2, 0.8], "end": [0.3, 0.8001, 0.4]},
}


@pytest.mark.parametrize("key", list(_SHORT))
def test_short_block_vector_raises(key):
    """A block's start or end shorter than dim raises a ValueError naming
    the block and both lengths, where tisph_tpu takes the shorter length
    (and its run fails later, in the cell binning): first a 3-vector
    domain with a 2-vector fluid block start."""
    raw = {"configuration": {"domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.0, 1.0, 1.0]},
           "fluidBlocks": [], key: [_SHORT[key]]}
    assert tt.scene_from_dict(raw).dim == 3
    which = "end" if key == "boundaryBlocks" else "start"
    with pytest.raises(ValueError, match=rf"{key}\[0\]: {which} has 2 entries, the scene's "
                                         "dim is 3"):
        pt.scene_from_dict(raw)


def test_longer_block_vectors_are_truncated():
    """A 2D scene may give 3-vectors: they are cut to dim, as in tisph_tpu."""
    raw = {"configuration": {"dim": 2, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1]},
           "fluidBlocks": [{"start": [0.1, 0.1, 0.1], "end": [0.5, 0.5, 0.5]}],
           "boundaryBlocks": [{"start": [0.6, 0.1, 0], "end": [0.8, 0.3, 1]}],
           "emitters": [{"start": [0.2, 0.8, 0], "end": [0.3, 0.8001, 0]}]}
    got = pt.scene_from_dict(raw)
    _fields_match(got, tt.scene_from_dict(raw))
    assert got.fluid_blocks[0].start == (0.1, 0.1) and got.emitters[0].end == (0.3, 0.8001)
