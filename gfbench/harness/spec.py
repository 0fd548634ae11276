"""A cell as its files describe it. Everything is found by name:

* ``BENCHMARK.json`` (the checkout's root): the cell's entry in
  ``workloads`` and the metrics it reports;
* ``gfbench/workloads/<cell>.json``: the trainer's settings, the
  reference's row block and the limits of the comparison;
* ``gfbench/configs/<config>.json``: the model's published keys, the
  keys the port runs otherwise (``as_run``, which take their place in
  ``Cell.config``), and the program's architecture id with the sizes its
  config must agree on;
* ``gfbench/traffic/<traffic>.json``: the rows, their length and the
  ranks that share them, the generator's branching, the distinct steps;
* ``gfbench/reference/<reference>.py``: the plain reference;
* ``gfbench/metrics/<metric>.py``: each metric's reader.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gfbench"


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    workload: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def reference(self):
        return importlib.import_module(
            f"gfbench.reference.{self.config['reference']}")

    @property
    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each weight's shape, by the reference's names."""
        return {n: tuple(s) for n, (s, _) in
                self.reference.param_shapes(self.config).items()}

    @property
    def rows(self) -> int:
        """Rows a rank trains on a step."""
        return self.traffic["rows_per_rank"]

    @property
    def seq_len(self) -> int:
        return self.traffic["seq_len"]

    @property
    def ranks(self) -> int:
        return self.traffic["ranks"]

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics this cell reports in a run (``--trace 1``: the
        per-layer ones)."""
        chosen = self.per_layer if trace else self.end_to_end
        return [m for m in chosen
                if self.name in m.get("workloads", [self.name])]


def reader(name: str):
    """A metric's reader module."""
    return importlib.import_module(f"gfbench.metrics.{name}")


def load(name: str, bench: Optional[Dict] = None,
         data: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: the root's
    BENCHMARK.json), its workload and traffic files under ``data``
    (default: ``gfbench``)."""
    if bench is None:
        bench = _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    data = data or BENCH
    workload = _json(data / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                      entry["traffic"]):
        raise ValueError(f"{name}: the workload file names another "
                         f"configuration or traffic than BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(ROOT / conf["file"])
    config = {**config, **config.get("as_run", {})}
    traffic = _json(data / "traffic" / f"{entry['traffic']}.json")
    if traffic["ranks"] != entry["chips"]:
        raise ValueError(f"{name}: {traffic['ranks']} ranks of traffic on "
                         f"{entry['chips']} chips")
    return Cell(name=name, chips=entry["chips"], config=config,
                workload=workload, traffic=traffic,
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
