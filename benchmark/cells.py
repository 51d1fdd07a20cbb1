"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- configuration: the ``file`` of its ``configs`` entry, a JSON file that
  names its scene file (beside it), the solver and its plain reference,
  ``<root>/reference/<reference>.py``;
- traffic mix: ``<root>/traffic/<mix>.json``;
- limits of the check: ``<root>/limits/<workload>.json``;
- metric: ``<root>/metrics/<name>.py``, else, for a name ``<base>.<mix>``,
  ``<root>/metrics/<base>.py`` called with the mix's name.

``<root>`` is the first of ``paths``, relative to the directory of
``BENCHMARK.json``.  Adding a configuration, a mix or a metric adds files
and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable

BENCHMARK_JSON = Path(__file__).resolve().parent.parent / "BENCHMARK.json"


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    spec: dict  # its BENCHMARK.json entry
    end_to_end: bool
    read: Callable  # read(record, variant) -> float | None
    variant: str | None  # the mix named by the name's suffix, if the reader is shared


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    root: Path  # the benchmark's folder
    workload: dict
    config: dict
    scene: dict
    scene_path: Path
    traffic_name: str
    traffic: dict
    limits: dict
    metrics: tuple[Metric, ...]  # the end-to-end ones, then the per-layer ones

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reader(root: Path, name: str) -> tuple[Callable, str | None]:
    """The metric's ``read`` and the mix its name's suffix names."""
    path, variant = root / "metrics" / f"{name}.py", None
    if not path.exists() and "." in name:
        base, variant = name.rsplit(".", 1)
        path = root / "metrics" / f"{base}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for the metric {name!r} under {root / 'metrics'}")
    return load_module(path, f"benchmark_metric_{name}").read, variant


def _reported(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or,
    without that key, every cell that reports its end-to-end metric."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench_json: Path = BENCHMARK_JSON) -> Cell:
    bench_json = Path(bench_json)
    bench = _json(bench_json)
    base = bench_json.parent
    root = base / bench["paths"][0]
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in {bench_json} (has {sorted(workloads)})")
    w = workloads[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_path = base / cfg_entry["file"]
    config = _json(cfg_path)
    scene_path = cfg_path.parent / config["scene"]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reported(m, name, e2e_names)]
    metrics = []
    for spec, is_e2e in [(m, True) for m in e2e] + [(m, False) for m in layer]:
        read, variant = _reader(root, spec["name"])
        metrics.append(Metric(spec["name"], spec, is_e2e, read, variant))
    return Cell(name=name, root=root, workload=w, config=config, scene=_json(scene_path),
                scene_path=scene_path, traffic_name=w["traffic"],
                traffic=_json(root / "traffic" / f"{w['traffic']}.json"),
                limits=_json(root / "limits" / f"{name}.json"), metrics=tuple(metrics))
