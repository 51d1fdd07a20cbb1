"""S0 from a scene and a seed: bitwise what it was for the committed
configurations, boundary blocks as the program samples them, and what
the benchmark cannot make yet refused (rigid bodies: test_bench_rigid)."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from benchmark import inputs
from benchmark.cells import load_cell
from benchmark.tests import tiny

# S0's frozen digests: ``configs/<config>.s0.json`` beside a configuration,
# one digest a seed, taken as the benchmark made S0 before scenes could hold
# boundary blocks. A configuration added later may bring its own file.
CONFIGS = tiny.REPO / "benchmark" / "configs"
FROZEN = {(f.name[:-len(".s0.json")], int(seed)): digest
          for f in sorted(CONFIGS.glob("*.s0.json"))
          for seed, digest in json.loads(f.read_text())["seeds"].items()}
BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def _digest(s0: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(s0):
        h.update(k.encode())
        h.update(np.ascontiguousarray(s0[k]).tobytes())
    return h.hexdigest()


def _config_cell(config: str):
    return load_cell(next(w["name"] for w in BENCH["workloads"] if w["config"] == config))


@pytest.mark.parametrize("config,seed", sorted(FROZEN))
def test_start_states_match_their_frozen_digests(config, seed):
    c = _config_cell(config)
    assert _digest(inputs.start_state(c.scene, float(c.config["jitter"]), seed)) == \
        FROZEN[config, seed]


# seed 0's S0 of each configuration, as the benchmark made it before it
# took rigid bodies (and with them tags other than the start rows)
SEED_0 = {
    "demo_3d": "a9457c0244cf19269c86eb8e28c8cada183a72d888d21c12bab4f9e94f77d5e0",
    "demo_2d_v1": "227068f09358e523fead4858a77683302a4aafe053a30221bd5273147cd374cb",
    "dam_1m": "9824bfa872eda4706fbbc7748bd100342591a5fa5080d7e171c2de0adaa1e1e6",
    "spheric2": "b0ddfe2bf8001369f421bc35c9fa29e509a7922c05de05cc9d697f03c51ce9cb",
}


@pytest.mark.parametrize("config", sorted(SEED_0))
def test_seed_0_start_states_are_pinned(config):
    c = _config_cell(config)
    s0 = inputs.start_state(c.scene, float(c.config["jitter"]), 0, c.scene_path.parent)
    assert _digest(s0) == SEED_0[config]


def test_every_frozen_start_names_a_configuration():
    """Each digest file belongs to a configuration of ``BENCHMARK.json``, and
    the three that were there before boundary blocks keep theirs."""
    named = {k[0] for k in FROZEN}
    assert named <= {c["name"] for c in BENCH["configs"]}
    assert {"demo_3d", "demo_2d_v1", "dam_1m"} <= named


def test_boundary_blocks_as_the_program_builds_them():
    """The tank's rows are ``build_state``'s, boundary blocks first; the
    seed moves fluid rows only, with the draws of the same scene without
    its boundary."""
    import tisph_tpu_torch as tt

    scene = tiny.TINY_SCENES["tiny_3d_walls"][1]
    lat = inputs.lattice(scene)
    st = tt.build_state(tt.scene_from_dict(scene), device="cpu")
    n = int(lat["num_active"])
    assert st.num_active == n
    for k in ("x", "v", "density", "pressure", "mass", "volume", "material", "color"):
        assert np.array_equal(getattr(st, k)[:n].numpy(), lat[k]), k
    wall = lat["material"] == 0
    assert wall.sum() > 0 and not wall[np.argmax(~wall):].any()  # boundary rows first
    assert np.array_equal(lat["object_id"], np.arange(n))

    s0 = inputs.start_state(scene, 0.01, 2 ** 32 + 3)
    assert np.array_equal(s0["x"][wall], lat["x"][wall])
    fluid_only = inputs.start_state({k: v for k, v in scene.items() if k != "boundaryBlocks"},
                                    0.01, 2 ** 32 + 3)
    assert np.array_equal(s0["x"][~wall], fluid_only["x"])


@pytest.mark.parametrize("key", sorted(inputs.REFUSED))
def test_what_the_benchmark_cannot_make_is_refused(key):
    scene = json.loads(json.dumps(tiny.TINY_SCENES["tiny_3d"][1]))
    scene[key] = [{"start": [0.1, 0.1, 0.1], "end": [0.2, 0.2, 0.2],
                   "geometryFile": "box.obj", "velocity": [0.0, 0.0, 0.0]}]
    with pytest.raises(NotImplementedError, match=key):
        inputs.lattice(scene)

