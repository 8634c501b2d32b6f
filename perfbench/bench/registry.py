"""Finds a cell's parts by the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` (the checkout's root): the cells, and which metrics
  each cell reports;
- ``configs/<config>.json``: a deployment (data, index, source);
- ``workloads/<cell>.json``: the cell: its configuration's and traffic
  mix's names (as ``BENCHMARK.json`` gives them), the mix's parameters,
  read by ``bench/traffic.py`` and the driver, and the limits of the
  comparison that decides ``correct``;
- ``metrics/<metric>.py``: one reader a metric (``read(run)``);
- ``drivers/<index>.py``: the system under test for a config's ``index``.

A later cell, traffic mix, configuration or metric is new files and new
entries in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent  # perfbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


@dataclass
class Cell:
    name: str
    entry: dict      # the cell's entry in BENCHMARK.json
    config: dict     # configs/<config>.json
    traffic: dict    # workloads/<cell>.json: the traffic mix's parameters
    limits: dict     # workloads/<cell>.json: the check's limits


class Registry:
    """``data``: the directory that holds ``configs/`` and ``workloads/``
    (``perfbench/``); ``bench_json``: ``BENCHMARK.json``."""

    def __init__(self, data: Path = HERE, bench_json: Path = None):
        self.data = Path(data)
        self.bench_json = Path(bench_json or HERE.parent / "BENCHMARK.json")
        self.bench = json.loads(self.bench_json.read_text())

    def _json(self, folder: str, kind: str, name: str) -> dict:
        return json.loads((self.data / folder / f"{_name(kind, name)}.json").read_text())

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in {self.bench_json.name}")
        spec = self._json("workloads", "workload", name)
        for key in ("config", "traffic"):
            if spec.get(key) != entry[key]:
                raise ValueError(f"workloads/{name}.json names {key} "
                                 f"{spec.get(key)!r}, BENCHMARK.json {entry[key]!r}")
        traffic = {k: v for k, v in spec.items() if k != "limits"}
        return Cell(name, entry, self._json("configs", "config", entry["config"]),
                    traffic, spec["limits"])

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's ``end_to_end`` metrics, or with ``trace`` its
        ``per_layer`` ones: every entry whose ``workloads`` lists the
        cell or that has no ``workloads``."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py`` as a module."""
    path = HERE / "metrics" / f"{_name('metric', name)}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(index: str) -> ModuleType:
    """``drivers/<index>.py``: the system under test."""
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", index):
        raise ValueError(f"bad index name {index!r}")
    return importlib.import_module(f"perfbench.drivers.{index}")


def read_metrics(entries: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read; the others are left out."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
