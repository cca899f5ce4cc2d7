"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

- ``configs/<config>.json``: the deployment (quality, sizes, guarantees),
  named by the configuration's ``file``;
- ``traffic/<traffic>.json``: the mix (the program's entry and its
  options, images a request, warm-up, what the check keeps);
- ``metrics/<metric>.py``: one reader a per-layer metric, ``read(slice)``
  returning a number or None.

Nothing here names a cell, a configuration or a metric: a new one is new
files and new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SPEC = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    """One workload: its entry in ``BENCHMARK.json``, its configuration
    and traffic files, and the names of the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def quality(self) -> int:
        return int(self.config["quality"])

    @property
    def control(self) -> str:
        """The control of this cell's side (encode or decode), which the
        configuration names beside the precision it states."""
        return self.config["controls"][self.traffic["kind"]]


def load_spec(path: Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell called ``name`` in the checkout at ``root``; KeyError names
    what is missing."""
    spec = load_spec(root / SPEC.name) if spec is None else spec
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    traffic_file = root / BENCH_DIR.name / "traffic" / f"{w['traffic']}.json"
    with open(traffic_file) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / BENCH_DIR.name / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def control(name: str):
    """The ``patch`` context manager of ``controls/<name>.py``."""
    return importlib.import_module(f"benchmark.controls.{name}").patch
