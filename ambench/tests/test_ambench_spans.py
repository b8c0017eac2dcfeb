"""``ambench/spans.py`` and the readers of the program's spans and
in-kernel counters, on synthetic traces and records; a traced CPU run."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ambench import registry, run, spans  # noqa: E402

CELL = "am_flat_1m.bulk_k10"
#: The metrics this file's readers report.
READERS = ("cam_topk_select_pct", "cam_topk_insert_pct",
           "table_cast_span_pct", "search_host_idle_pct")

HOST, STREAM = (1, 11), (0, 7)


def _x(cat, name, ts, dur, where=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": where[0], "tid": where[1], "args": args}


def _trace(launches=True, launch_cat="cuda_runtime", annotations=False):
    """A window of 1,000 us: an ``am.search`` call that casts the table and
    launches the top-k, an upload before it, a pack the host never
    launched in the trace, and one kernel that nothing links.  With
    ``annotations``, the profiler's device-side images of the spans too,
    which hold the pack and must not place it."""
    ev = [_x("user_annotation", "ambench.window", 0, 1000),
          _x("user_annotation", "am.search", 100, 100),
          _x("user_annotation", "cam.cast.table", 110, 20),
          _x("user_annotation", "cam.topk", 140, 50),
          _x("cpu_op", "aten::copy_", 112, 5),
          _x("kernel", "direct_copy_kernel<signed char>", 300, 40, STREAM,
             correlation=1),
          _x("kernel", "cam_topk_partial_kernel", 340, 160, STREAM,
             correlation=2),
          _x("gpu_memcpy", "Memcpy HtoD", 60, 10, STREAM, correlation=3),
          _x("kernel", "cam_pack_kernel", 505, 10, STREAM, correlation=4),
          _x("kernel", "stray", 600, 10, STREAM, correlation=5)]
    if launches:
        ev += [_x(launch_cat, "cudaLaunchKernel", 115, 2, correlation=1),
               _x(launch_cat, "cuLaunchKernel", 150, 2, correlation=2),
               _x("cuda_runtime", "cudaMemcpyAsync", 50, 3, correlation=3)]
    if annotations:
        ev += [_x("gpu_user_annotation", "am.search", 300, 220, STREAM),
               _x("gpu_user_annotation", "cam.pack", 500, 20, STREAM)]
    return {"traceEvents": ev}


def _write(path: Path, trace: dict) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(trace))
    return path


@pytest.mark.parametrize("launch_cat,annotations", [
    ("cuda_runtime", False), ("cuda_driver", False), ("cuda_runtime", True)])
def test_kernels_are_placed_by_correlation_alone(tmp_path, launch_cat,
                                                 annotations):
    s = spans.read(_write(tmp_path / "t.json",
                          _trace(True, launch_cat, annotations)))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy"] == [(60.0, 70.0), (300.0, 500.0), (505.0, 515.0),
                         (600.0, 610.0)]
    assert s["gaps"][0] == (0.0, 60.0) and s["gaps"][-1] == (610.0, 1000.0)
    assert s["host"]["am.search"] == [(100.0, 200.0)]
    got = {k: v * 1e6 for k, v in s["device_s"].items()}
    linked = {k: v * 1e6 for k, v in s["linked_s"].items()}
    assert got == pytest.approx({"cam.cast.table": 40, "cam.topk": 160,
                                 None: 10})          # None: the upload
    assert linked == pytest.approx({"correlation": 210, "none": 20})


def test_no_link_no_window_no_trace(tmp_path):
    for annotations in (False, True):
        assert spans.read(_write(tmp_path / f"a{annotations}.json",
                                 _trace(False, annotations=annotations))) \
            is None
    no_window = _trace()
    no_window["traceEvents"] = no_window["traceEvents"][1:]
    assert spans.read(_write(tmp_path / "b.json", no_window)) is None
    assert spans.of_record({"cell": CELL, "trace": None}, tmp_path) is None
    assert spans.of_record({"cell": CELL, "trace": {}}, tmp_path) is None


def test_overlap_of_interval_lists():
    assert spans.overlap_s([(0, 10), (20, 30)], [(5, 25)]) == \
        pytest.approx(10e-6)
    assert spans.overlap_s([], [(0, 1)]) == 0.0


@pytest.fixture
def checkout(tmp_path):
    """The benchmark's files under a root of their own."""
    shutil.copytree(ROOT / "ambench", tmp_path / "ambench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def _read(name, record, root):
    return registry.module("metrics", name, root).read(record)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_none_on_an_untraced_record(name, checkout,
                                                   monkeypatch):
    _write(spans.trace_file({"cell": CELL}, checkout), _trace())
    monkeypatch.setattr(spans, "counters", lambda: dict.fromkeys(
        ("cam_topk.votes", "cam_topk.inserts", "cam_topk.cycles_compare",
         "cam_topk.cycles_select"), 1))
    assert _read(name, {"cell": CELL, "trace": None}, checkout) is None


def test_span_readers_on_a_synthetic_trace(checkout):
    _write(spans.trace_file({"cell": CELL}, checkout), _trace())
    rec = {"cell": CELL, "trace": {}}
    # 40 of the 230 us busy under cam.cast.table
    assert _read("table_cast_span_pct", rec, checkout) == pytest.approx(
        100 * 40 / 230)
    # am.search holds [100, 200], all idle: 100 of 1,000 us
    assert _read("search_host_idle_pct", rec, checkout) == pytest.approx(
        10.0)


def test_counter_readers(checkout, monkeypatch):
    rec = {"cell": CELL, "trace": {}}
    c = {"cam_topk.votes": 400, "cam_topk.inserts": 30,
         "cam_topk.cycles_compare": 100, "cam_topk.cycles_select": 300}
    monkeypatch.setattr(spans, "counters", lambda: c)
    assert _read("cam_topk_insert_pct", rec, checkout) == 7.5
    assert _read("cam_topk_select_pct", rec, checkout) == 75.0
    monkeypatch.setattr(spans, "counters", lambda: dict.fromkeys(c, 0))
    assert _read("cam_topk_insert_pct", rec, checkout) is None
    assert _read("cam_topk_select_pct", rec, checkout) is None
    monkeypatch.setattr(spans, "counters", lambda: None)   # no program obs
    assert _read("cam_topk_insert_pct", rec, checkout) is None


def test_the_bulk_cells_list_the_new_metrics():
    bench = registry.benchmark()
    for cell in ("am_flat_1m.bulk_k10", "am_flat_1m.bulk_k100"):
        names = {m["name"] for m in registry.metrics(bench, cell, True)}
        assert set(READERS) <= names


def test_a_traced_cpu_run_reads_nothing_it_cannot_see(checkout, monkeypatch):
    """On the CPU no work runs on a device, so the trace readers find
    nothing and the counters stay zero: the metrics are left out, and
    nothing raises."""
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    out = run.run_cell(CELL, 2**31 + 11, 0.3, True, need_card=False,
                       device="cpu", root=checkout,
                       config_over={"table": {"rows": 2048,
                                              "capacity": 2048}},
                       mix_over={"batch_lookups": 64, "batches_in_flight": 2,
                                 "warmup_batches": 2})
    assert out["correct"]
    assert not set(READERS) & set(out["metrics"])
    s = spans.read(spans.trace_file({"cell": CELL}, checkout))
    assert s is not None and not s["busy"]
    assert "am.search" in s["host"] and "cam.cast.table" in s["host"]
