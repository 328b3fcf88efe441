"""BENCHMARK.json and the files it names: a cell names a configuration
(`configs[].file`), a traffic mix (portbench/traffic/<traffic>.json) and,
through its end-to-end and per-layer metrics, one reader each
(portbench/metrics/<metric>.py).  Adding a cell, a configuration, a
traffic mix or a metric is adding files and entries; no file here names
one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TRAFFIC_DIR = os.path.join("portbench", "traffic")
METRIC_DIR = os.path.join("portbench", "metrics")
GENERATOR_DIR = os.path.join("portbench", "generators")


class Manifest:
    def __init__(self, root: str = "."):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        with open(os.path.join(self.root, self.configs[cell["config"]]["file"])) as f:
            return json.load(f)

    def traffic(self, cell: dict) -> dict:
        with open(os.path.join(self.root, TRAFFIC_DIR, cell["traffic"] + ".json")) as f:
            return json.load(f)

    def reader(self, metric: str):
        """The module that reads `metric`: portbench/metrics/<metric>.py."""
        return _load(os.path.join(self.root, METRIC_DIR, metric + ".py"))

    def generator(self, traffic: dict):
        """The module that draws a traffic mix's reads:
        portbench/generators/<generator>.py."""
        return _load(os.path.join(self.root, GENERATOR_DIR, traffic["generator"] + ".py"))

    def metrics(self, cell: dict, kind: str) -> list[dict]:
        """The cell's `end_to_end` or `per_layer` metrics: those without a
        `workloads` key, and those whose key lists the cell."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]


_LOADED: dict = {}


def _load(path: str):
    path = os.path.abspath(path)
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            "portbench_data_" + str(len(_LOADED)), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
