"""A cell of `BENCHMARK.json`, resolved to its files by name.

A cell names a configuration (its `file` in `configs`) and a traffic mix
(`traffic/<mix>.json`); the mix names an operation (`ops/<op>.py`); each
metric is read by `metrics/<name>.py`.  Adding any of them is adding a
file and an entry.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """A reader or an operation, loaded from its file (a metric's name
    may hold dots, so it is no importable module name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    safe = "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(
        f"portbench._loaded.{path.parent.name}.{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell_metrics(metrics: list[dict], cell: str,
                  reported: set[str] | None) -> list[dict]:
    """The metrics a cell reports: those that list it under `workloads`,
    and, where a metric lists none, every cell (end to end) or every
    cell that reports the end-to-end metric it moves (per layer)."""
    out = []
    for metric in metrics:
        if "workloads" in metric:
            if cell in metric["workloads"]:
                out.append(metric)
        elif reported is None or metric["moves"] in reported:
            out.append(metric)
    return out


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def op(self) -> str:
        return self.traffic["op"]

    def op_module(self) -> ModuleType:
        return load_module(HERE / "ops" / f"{self.op}.py")

    def reader(self, metric: dict) -> ModuleType:
        return load_module(HERE / "metrics" / f"{metric['name']}.py")


def resolve(name: str) -> Cell:
    """The cell `name` with its configuration, mix and metrics."""
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = _cell_metrics(bench["end_to_end"], name, None)
    reported = {m["name"] for m in e2e}
    per_layer = _cell_metrics(bench["per_layer"], name, reported)
    return Cell(name, int(cell["chips"]), config, traffic, e2e, per_layer)
