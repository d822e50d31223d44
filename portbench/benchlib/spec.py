"""A cell's pieces, found by the names in BENCHMARK.json: its configuration
file, its traffic mix, its energy's generator and reference, its metrics'
readers and its check's limits."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: number -> limit
    metrics: list  # BENCHMARK.json's metric entries this run reports

    @property
    def lm(self):
        return self.traffic["solver"] == "LMGPU"

    def energy(self):
        """The energy's generator, work tables, test size and PCG kernels
        (energies/<energy>.py)."""
        return importlib.import_module(
            f"portbench.energies.{self.config['energy']}")

    def reference(self):
        """The energy's plain residuals (reference/<energy>.py)."""
        return importlib.import_module(
            f"portbench.reference.{self.config['energy']}")


def read_json(path):
    return json.loads(Path(path).read_text())


def applies(entry, cell_name):
    """A metric without a workloads key is every cell's."""
    return "workloads" not in entry or cell_name in entry["workloads"]


def load_cell(bench, name, trace, root=ROOT):
    """The Cell of workload `name`, with the end-to-end metrics (trace
    False) or the per-layer ones (trace True) that it reports."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")["limits"]
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, metrics)


def reader(metric_name):
    """read(run) of metrics/<metric_name>.py."""
    path = HERE / "metrics" / f"{metric_name}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", metric_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
