"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric, driver, work count or corpus sits in a file of its own, found by
name, so that a later cell, metric or configuration adds files and edits
none:

    BENCHMARK.json             cells, metrics, bounds
    portbench/configs/<c>.json   a configuration (BENCHMARK.json names it)
    portbench/traffic/<t>.json   a traffic mix: parameters and its driver
    portbench/limits/<cell>.json the limits that decide `correct` in a cell
    portbench/drivers/<d>.py     a driver: run(bench, params) -> Window
    portbench/metrics/<m>.py     a per-layer metric: read(ctx) -> number | None
    portbench/work/<w>.py        a scoring stage's work from shapes
    portbench/corpora/<g>.py     a corpus generator: make(spec, seed, ...)
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
_modules: dict = {}


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(*parts: str) -> dict:
    with open(os.path.join(PORTBENCH, *parts)) as f:
        return json.load(f)


def load_config(bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "configuration")
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def load_limits(workload: str) -> dict:
    return _json("limits", f"{workload}.json")


def module(kind: str, name: str):
    """portbench/<kind>/<name>.py, loaded by path (a metric's name may
    hold dots)."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(PORTBENCH, kind, f"{name}.py")
    key = (kind, name)
    if key not in _modules:
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The metrics of one section that this cell reports."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]
