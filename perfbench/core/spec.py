"""BENCHMARK.json and the files it names, found by name.

A cell of ``workloads`` names a configuration (``configs/<name>.json``, its
topology ``.xml`` beside it and its reference ``reference/<name>.py``) and a
traffic mix (``traffic/<name>.json``, driven by ``drivers/<kind>.py``); a
per-layer metric ``metrics/<name>.py``.  Nothing here lists a configuration,
a mix, a kind of traffic or a metric: adding one is adding its files and its
entries in BENCHMARK.json.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parents[1]   # perfbench/
ROOT = HERE.parent                           # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<name>.json, with "name" and "xml" (a path)
    traffic: dict         # traffic/<name>.json, with "name"
    end_to_end: List[dict]
    per_layer: List[dict]
    base: Path = HERE     # the benchmark's folder the files were found in


def load_json(path: Path) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def config(name: str, base: Path = HERE) -> dict:
    cfg = load_json(base / "configs" / f"{name}.json")
    cfg["name"] = name
    cfg["xml"] = str(base / "configs" / cfg["topology"])
    return cfg


def traffic(name: str, base: Path = HERE) -> dict:
    mix = load_json(base / "traffic" / f"{name}.json")
    mix["name"] = name
    return mix


def _applies(metric: dict, cell: dict, reported: set) -> bool:
    """A metric with a ``workloads`` key is read in those cells; one without
    it in every cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell(name: str, bench: Optional[dict] = None, base: Path = HERE) -> Cell:
    """The cell ``name`` of BENCHMARK.json (at the checkout's root beside
    ``base``), with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_json(base.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, entry, reported)]
    return Cell(name, int(entry["chips"]), config(entry["config"], base),
                traffic(entry["traffic"], base), e2e, layer, base)


def module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
