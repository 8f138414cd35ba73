"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell ``<cell>`` is ``workloads/<cell>.json`` (its driver, its compared
rounds, its traced seconds and its correctness limits); its configuration
is the file ``BENCHMARK.json`` names for it, its traffic mix
``traffic/<traffic>.json``, its driver ``drivers/<driver>.py``, and each
per-layer metric ``metrics/<metric>.py``. Adding a cell, a mix or a metric
adds files and entries; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench: Dict = None) -> Cell:
    bench = bench if bench is not None else manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, chips=entry["chips"],
                workload=json.loads((BENCH / "workloads" / f"{name}.json").read_text()),
                config=json.loads((ROOT / cfg_entry["file"]).read_text()),
                traffic=json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
