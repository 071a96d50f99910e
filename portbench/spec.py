"""The benchmark's data: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, entry,
generator, reference, control or metric sits in a file of its own under
`portbench/`, found by name:

    configs/<config>.json   the deployment (BENCHMARK.json names the file);
                            its `"model"` and `"controls"` name its
                            reference and controls
    traffic/<mix>.json      the mix: its generator, entry and parameters
    gen/<generator>.py      builds a pool of inputs from a seed
    entries/<entry>.py      drives the program under the mix's load
    reference/<model>.py    judges every answer of the configurations
                            of `"model"`, each '-' of it read '_'
    controls/<control>.py   the reference with one stated guarantee
                            broken: the configuration's `"controls"`
    e2e/<metric>.py         reads one end-to-end metric of a run
    metrics/<metric>.py     reads one per-layer metric of a traced run
    tests/tiny/<config>.json  the configuration's sizes for the CPU tests

A later change adds a cell by adding such files and entries in
BENCHMARK.json; no file that is there needs an edit (the tests'
`test_new_files_are_found_by_name` adds a cell so).
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

PKG = os.path.dirname(os.path.abspath(__file__))

#: the kinds of file the harness finds by name, and their suffixes
KINDS = {
    "configs": ".json",
    "traffic": ".json",
    "gen": ".py",
    "entries": ".py",
    "reference": ".py",
    "controls": ".py",
    "e2e": ".py",
    "metrics": ".py",
}


def discover(pkg: str = PKG) -> Dict[str, List[str]]:
    """Every name of every kind under `pkg` (helper modules, whose
    names start with `_`, left out)."""
    out: Dict[str, List[str]] = {}
    for kind, suffix in KINDS.items():
        d = os.path.join(pkg, kind)
        names = []
        if os.path.isdir(d):
            for f in os.listdir(d):
                if f.endswith(suffix) and not f.startswith("_"):
                    names.append(f[: -len(suffix)])
        out[kind] = sorted(names)
    return out


def load_module(pkg: str, kind: str, name: str):
    """The module `<pkg>/<kind>/<name>.py`, loaded from its path (a
    metric's name may hold dots)."""
    path = os.path.join(pkg, kind, name + ".py")
    if not os.path.isfile(path):
        raise LookupError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with the data it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    pkg: str


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, workload: str, pkg: str = PKG) -> Cell:
    """The cell named `workload` of `<root>/BENCHMARK.json`."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise LookupError(
            f"no workload {workload!r} in BENCHMARK.json; have "
            f"{sorted(wl)}")
    w = wl[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, cfg_entry["file"]))
    traffic = _read_json(os.path.join(pkg, "traffic", w["traffic"] + ".json"))
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        pkg=pkg,
    )
