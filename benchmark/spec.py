"""Finds a cell's parts by name: its entry in BENCHMARK.json, its
configuration file, its traffic mix and the readers of its per-layer
metrics.  A later cell, configuration, mix or metric is a new file and a
new entry here; no code changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with what it names."""

    name: str
    chips: int
    config: Dict            # the configuration file's contents
    traffic: Dict           # the traffic mix's parameters
    end_to_end: List[Dict]  # the metrics this cell reports untraced
    per_layer: List[Dict]   # ... and traced


def _applies(metric: Dict, cell: str,
             reported: Optional[List[str]] = None) -> bool:
    """A metric with ``workloads`` applies to those cells; without, an
    end-to-end metric (``reported`` None) applies to every cell and a
    per-layer metric to every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def cell(name: str, spec: Optional[Dict] = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json (KeyError if there is none)."""
    spec = spec if spec is not None else load(root)
    entry = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: str = ROOT) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``: the metric's value, or
    None where the run gave it nothing to read."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def problems(spec: Dict) -> List[str]:
    """What in ``spec`` breaks the naming rules (empty when none does)."""
    out = []
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec.get(group, []):
            names.append((group, e.get("name", "")))
    for group, n in names:
        if not NAME_RE.match(n):
            out.append(f"{group}: bad name {n!r}")
    for group in ("configs", "workloads"):
        seen = [n for g, n in names if g == group]
        if len(seen) != len(set(seen)):
            out.append(f"{group}: names repeat")
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    if len(metrics) != len(set(metrics)):
        out.append("metrics: names repeat")
    for w in spec.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME_RE.match(w.get(key, "")):
                out.append(f"workload {w.get('name')}: bad {key}")
    for c in spec.get("configs", []):
        for k in c.get("reduced", []):
            if not NAME_RE.match(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
    for group in ("end_to_end", "per_layer"):
        for m in spec.get(group, []):
            if not UNIT_RE.match(m.get("unit", "")):
                out.append(f"{m['name']}: bad unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                out.append(f"{m['name']}: better must be lower or higher")
    return out
