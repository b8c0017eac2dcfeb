"""CPU tests of the benchmark's parts: traffic, registry, metric readers,
and the imports it may not make."""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ambench import loops, registry, run, traffic  # noqa: E402


@pytest.fixture(autouse=True)
def _hide_jax(monkeypatch):
    """Other test files load JAX and ``repro`` into this worker; a run
    refuses to report once it sees them, so they are hidden here."""
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)

# -- traffic ------------------------------------------------------------------

@pytest.mark.parametrize("mix", ["bulk_k10", "zipf_open"])
def test_keys_repeat_from_the_seed(mix):
    m = registry.traffic(mix)
    s = traffic.seeds(2**33 + 1)
    a = traffic.Keys(m, 5000, s["keys"], s["order"])
    b = traffic.Keys(m, 5000, s["keys"], s["order"])
    assert np.array_equal(a.draw(3000), b.draw(3000))
    assert [a.next() for _ in range(10)] == [b.next() for _ in range(10)]
    c = traffic.Keys(m, 5000, traffic.seeds(2)["keys"], s["order"])
    assert not np.array_equal(a.draw(3000), c.draw(3000))


def test_arrivals_repeat_and_hold_their_count():
    a = traffic.arrivals(1234.0, 2.0, 99)
    assert np.array_equal(a, traffic.arrivals(1234.0, 2.0, 99))
    assert a.size == 2468 and np.all(np.diff(a) >= 0)
    assert 0.0 <= a[0] and a[-1] < 2.0
    assert traffic.seeds(5) == traffic.seeds(5)
    assert len(set(traffic.seeds(5).values())) == len(traffic.seeds(5))


def test_zipf_keys_are_skewed_by_rank():
    m = registry.traffic("zipf_open")
    s = traffic.seeds(3)
    k = traffic.Keys(m, 10000, s["keys"], s["order"]).draw(50000)
    counts = np.bincount(k, minlength=10000)
    hot = np.random.default_rng(s["order"]).permutation(10000)[0]
    assert counts.argmax() == hot and counts[hot] > 0.05 * k.size


def test_reservoir_is_uniform_and_seeded():
    a, b = loops.Reservoir(100, 4), loops.Reservoir(100, 4)
    for i in range(10000):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 100
    assert np.mean(a.items) > 2000          # not just the first hundred


# -- registry -----------------------------------------------------------------

def _with_later(bench: dict) -> dict:
    """``bench`` with the cells left for later (``ambench/later.json``)."""
    later = json.loads((ROOT / "ambench" / "later.json").read_text())
    return registry.merge(bench, later)


@pytest.mark.parametrize("later", [False, True])
def test_everything_in_the_benchmark_is_found_by_name(later):
    bench = registry.benchmark()
    if later:
        bench = _with_later(bench)
    for w in bench["workloads"]:
        cfg = registry.config(bench, w["config"])
        assert registry.module("systems", cfg["system"])
        assert registry.module("references", cfg["reference"])
        assert registry.traffic(w["traffic"])["k"] >= 1
        for trace in (False, True):
            for m in registry.metrics(bench, w["name"], trace):
                assert callable(registry.module("metrics", m["name"]).read)


@pytest.mark.parametrize("later", [False, True])
def test_metrics_follow_their_workload_lists(later):
    bench = registry.benchmark()
    if later:
        bench = _with_later(bench)
        names = lambda cell, t: {m["name"]
                                 for m in registry.metrics(bench, cell, t)}
        assert names("am_flat_1m.zipf_open", False) == {
            "lookup_p99_ms", "peak_mem_gib", "setup_s"}
        assert "dedup_pct" in names("am_flat_1m.zipf_open", True)
        assert "ivf_candidate_pct" in names("am_ivf_1m.bulk_k10", True)
    names = lambda cell, t: {m["name"] for m in registry.metrics(bench, cell, t)}
    assert "dedup_pct" not in names("am_flat_1m.bulk_k10", True)
    assert names("am_flat_1m.bulk_k100", False) == {
        "lookups_per_s", "peak_mem_gib", "setup_s"}
    moves = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in moves
        for cell in m["workloads"]:
            assert m["moves"] in names(cell, False)


# -- metric readers -----------------------------------------------------------

def _record(**kw):
    rec = {
        "config": {"table": {"rows": 1000, "width": 4, "bits": 3},
                   "index": None},
        "setup_s": 7.5, "peak_bytes": 3 * 2**30, "window_s": 2.0,
        "completed": 500, "slice_completed": 200, "after_slice": 500,
        "latency_s": np.arange(1, 1001) / 1000.0,
        "gen_lag_s": np.arange(1, 1001) / 1e6,
        "counters": {"groups": 10, "dispatched": 400, "dedup_hits": 100,
                     "launches": {"cam_search_topk": 30}},
        "reference": {},
        "trace": {"window_s": 1.0, "busy_s": 0.25,
                  "device_ops_s": {"void cam_topk_partial_kernel<3>": 2e-8,
                                   "cam_topk_merge_kernel": 2e-8,
                                   "elementwise<direct_copy_kernel_cuda"
                                   "{lambda(signed char)}>": 0.05,
                                   "elementwise<direct_copy_kernel_cuda"
                                   "{lambda(float)}>": 0.07,
                                   "cam_pack_kernel": 1.0}},
    }
    rec.update(kw)
    return rec


def _read(name, rec):
    return registry.module("metrics", name).read(rec)


def test_metric_readers_on_a_synthetic_record():
    rec = _record()
    assert _read("setup_s", rec) == 7.5
    assert _read("lookups_per_s", rec) == 250.0
    assert _read("peak_mem_gib", rec) == 3.0
    # lookups 501..1000 (from a second after the slice closed)
    assert _read("lookup_p99_ms", rec) == pytest.approx(995.99)
    assert _read("lookup_p99_ms", _record(after_slice=0)) == pytest.approx(
        990.99)
    assert _read("gen_lag_p99_ms", rec) == pytest.approx(0.99599)
    assert _read("group_lookups_mean", rec) == 40.0
    assert _read("dedup_pct", rec) == 25.0
    assert _read("device_idle_pct.bulk", rec) == 75.0
    assert _read("device_idle_pct.open", rec) == 75.0
    assert _read("table_cast_pct", rec) == pytest.approx(20.0)
    assert _read("table_cast_pct", _record(trace={
        "window_s": 1.0, "busy_s": 0.25, "device_ops_s": {}})) is None
    assert _read("ivf_fine_launches_per_group", rec) is None
    assert _read("ivf_candidate_pct", rec) is None
    # 10 groups of 30 distinct lookups (400 dispatched, 100 shared) x 1000
    # rows x 4 symbols: each group reads more bytes, (30 + 1000) x 4 x 3
    # bits, than the peak compares in the time they take, over 40 ns
    group_s = max(30 * 1000 * 4 / 1.979e15, 1030 * 4 * 3 / 8 / 3.35e12)
    assert group_s == 1030 * 1.5 / 3.35e12
    assert _read("cam_search_topk_roofline", rec) == pytest.approx(
        100 * 10 * group_s / 4e-8)
    # one group of 300: now the compares bound it
    big = _record(counters={"groups": 1, "dispatched": 300, "dedup_hits": 0,
                            "launches": {}})
    assert _read("cam_search_topk_roofline", big) == pytest.approx(
        100 * 300 * 1000 * 4 / 1.979e15 / 4e-8)
    assert _read("search_mfu", rec) == pytest.approx(
        100 * 300 * 1000 * 4 / 1.979e15)


def test_indexed_readers_use_the_reference_partition():
    rec = _record(config={"table": {"rows": 1000, "width": 4, "bits": 3},
                          "index": {"sets": 16}},
                  reference={"candidate_rows_mean": 50.0})
    assert _read("ivf_fine_launches_per_group", rec) == 3.0
    assert _read("ivf_candidate_pct", rec) == 5.0
    assert _read("search_mfu", rec) == pytest.approx(
        100 * 300 * 66 * 4 / 1.979e15)
    assert _read("cam_search_topk_roofline", _record(
        config=rec["config"], reference={})) is None
    assert _read("device_idle_pct.bulk", _record(trace=None)) is None
    assert _read("lookup_p99_ms", _record(latency_s=None)) is None


# -- what the benchmark may import ---------------------------------------------

def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in (ROOT / "ambench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")


def test_the_reference_imports_nothing_of_the_program():
    for sub in ("references", "frozen"):
        for path in (ROOT / "ambench" / sub).glob("*.py"):
            assert "repro_torch" not in _imports(path), path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", sys)
    assert run.forbidden_modules() == ["repro"]
