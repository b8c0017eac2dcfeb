"""The reader of ``cam_topk_keys_per_insert``: keys the fused top-k's
partial pass offered to its lists per vote that inserted, from the
kernel's own counters."""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ambench import registry, spans  # noqa: E402

NAME = "cam_topk_keys_per_insert"
CELL = "am_flat_1m.bulk_k100"
COUNTERS = {"cam_topk.votes": 400, "cam_topk.inserts": 30,
            "cam_topk.cycles_compare": 100, "cam_topk.cycles_select": 300,
            "cam_topk.offered": 135}


@pytest.fixture
def checkout(tmp_path):
    """The benchmark's files under a root of their own."""
    shutil.copytree(ROOT / "ambench", tmp_path / "ambench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _read(record, root):
    return registry.module("metrics", NAME, root).read(record)


@pytest.mark.parametrize("counters,want", [
    (COUNTERS, 4.5),
    (dict.fromkeys(COUNTERS, 0), None),                # no vote inserted
    ({n: v for n, v in COUNTERS.items()                # a kernel that does
      if n != "cam_topk.offered"}, None),              # not count offers
    (None, None),                                      # no program obs
])
def test_keys_per_insert_reads_offered_over_inserts(counters, want, checkout,
                                                    monkeypatch):
    monkeypatch.setattr(spans, "counters", lambda: counters)
    assert _read({"cell": CELL, "trace": {}}, checkout) == want


def test_keys_per_insert_is_none_on_an_untraced_record(checkout,
                                                      monkeypatch):
    monkeypatch.setattr(spans, "counters", lambda: COUNTERS)
    assert _read({"cell": CELL, "trace": None}, checkout) is None


def test_the_bulk_cells_list_keys_per_insert():
    bench = registry.benchmark()
    for cell in ("am_flat_1m.bulk_k10", "am_flat_1m.bulk_k100"):
        assert NAME in {m["name"]
                        for m in registry.metrics(bench, cell, True)}
