"""The benchmark's files parse, follow the contract's shapes, and a cell
made of new files only is found and run without an edit."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from benchmark import check
from benchmark.cells import load_cell
from benchmark.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and 1 <= len(c["source"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m["workloads"]:
            assert cell in CELLS
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_parse(cell):
    c = load_cell(cell)
    assert (c.root / "reference" / f"{c.config['reference']}.py").exists()
    assert set(c.limits["limits"]) == set(check.NUMBERS)
    for key in ("episode_steps", "chunk_steps", "dump", "health_read", "check_random"):
        assert key in c.traffic
    names = {m.name for m in c.metrics}
    assert {"setup_s", "peak_mem_mib"} <= {m.name for m in c.metrics if m.end_to_end}
    # the rate end to end, or per layer where the host's noise swamps it
    assert "particle_steps_per_s" in names or "particle_steps_per_s.frames" in names
    assert any(not m.end_to_end for m in c.metrics)


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a metric reader and limits added as
    files to a copy of the folder: the copy's cell loads and runs, and
    reports the new metric."""
    bench_json = tiny.make_copy(tmp_path)
    root = tmp_path / "benchmark"
    (root / "metrics" / "answers_per_s.py").write_text(
        "def read(rec, variant):\n    return rec.answers / rec.wall_s\n")
    bench = json.loads(bench_json.read_text())
    bench["end_to_end"].append({"name": "answers_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny_2d_v1.tiny_frames"]})
    bench_json.write_text(json.dumps(bench))
    line = tiny.run(bench_json, "tiny_2d_v1.tiny_frames")
    assert line["correct"], line["checked"]
    assert line["metrics"]["answers_per_s"]["value"] > 0
    assert list(line)[-1] == "checked"


def test_refuses_without_a_card(tmp_path):
    """The measuring path fails on the CPU: exit 3, no result line, in the
    repo and in a folder holding only BENCHMARK.json and the benchmark."""
    import torch

    bench_json = tiny.make_copy(tmp_path)
    # on a card the repo's run would measure; the copy has no program to run
    places = (bench_json.parent,) if torch.cuda.is_available() else (tiny.REPO,
                                                                      bench_json.parent)
    for cwd in places:
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "demo_3d.run",
                            "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
