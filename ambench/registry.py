"""Finds the benchmark's pieces by name: cells, configurations, traffic
mixes, metric readers, systems and references.

Everything is looked up under one root (the checkout's, or a test's), so a
piece added as a file and a ``BENCHMARK.json`` entry is found with no edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "ambench"


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` under ``root``."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry called ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r}; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of the ``configs`` entry called ``name``."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r}")


def traffic(name: str, root: Path = ROOT) -> dict:
    """``<PKG>/traffic/<name>.json``."""
    with open(root / PKG / "traffic" / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str, root: Path = ROOT):
    """``<PKG>/<kind>/<name>.py`` loaded as a module (a name may hold dots)."""
    path = root / PKG / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"{PKG}.{kind}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics cell ``name`` reports: its end-to-end metrics, or with
    ``trace`` the per-layer metrics listed for it or, without a list,
    those that move one of its end-to-end metrics."""
    listed = lambda m: "workloads" in m
    e2e = [m for m in bench["end_to_end"]
           if not listed(m) or name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if listed(m) else m["moves"] in moved)]


def merge(bench: dict, extra: dict) -> dict:
    """``bench`` with the entries of ``extra`` (a ``BENCHMARK.json``-shaped
    dict, such as ``later.json``'s cells left for later) added; an
    end-to-end metric already there gains ``extra``'s cells."""
    out = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "per_layer"):
        out[key] += extra.get(key, [])
    listed = {m["name"]: m for m in out["end_to_end"]}
    for m in extra.get("end_to_end", []):
        if m["name"] in listed:
            listed[m["name"]]["workloads"] += m["workloads"]
        else:
            out["end_to_end"].append(m)
    return out
