"""Whole runs of the harness at a tiny size on the CPU: a new cell by data
alone, the result line, faults the check has to catch, the control; and a
short run on the card."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ambench import registry, run  # noqa: E402


@pytest.fixture(autouse=True)
def _hide_jax(monkeypatch):
    """Other test files load JAX and ``repro`` into this worker; a run
    refuses to report once it sees them, so they are hidden here."""
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)

#: A tiny table for CPU runs: the cells' widths, few rows.
TINY = {"table": {"rows": 2048, "capacity": 2048, "fill_chunk": 512},
        "service": {"max_batch": 64}}
TINY_IVF = {"index": {"sets": 16, "probes": 4, "min_rows": 2048}}
TINY_MIX = {"outstanding": 128, "warmup_lookups": 128,
            "rate_per_s": 400, "warmup_s": 0.1,
            "batch_lookups": 64, "batches_in_flight": 2, "warmup_batches": 2}


def _tiny(cell: str) -> dict:
    over = copy.deepcopy(TINY)
    if cell.startswith("am_ivf"):
        over.update(TINY_IVF)
    return over


#: The cells left for later (``ambench/later.json``), ready to be added
#: back by data alone: their configuration, mixes, reference and readers
#: are in ``ambench/``.
LATER = json.loads((ROOT / "ambench" / "later.json").read_text())
IVF_CELL = "am_ivf_1m.bulk_k10"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose benchmark also holds the cells left for later."""
    top = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "ambench", top / "ambench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = registry.merge(registry.benchmark(), LATER)
    (top / "BENCHMARK.json").write_text(json.dumps(bench))
    return top


def _run(cell: str, root: Path, seed: int = 2**31 + 5, trace=False) -> dict:
    return run.run_cell(cell, seed, 0.3, trace, need_card=False,
                        device="cpu", config_over=_tiny(cell),
                        mix_over=TINY_MIX, root=root)


# -- extension by data --------------------------------------------------------

def test_a_new_cell_mix_and_metric_need_no_edit(tmp_path):
    shutil.copytree(ROOT / "ambench", tmp_path / "ambench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = registry.benchmark()
    bench["workloads"].append({
        "name": "am_flat_1m.burst", "config": "am_flat_1m",
        "traffic": "burst", "chips": 1, "why": "test"})
    bench["end_to_end"].append({
        "name": "answered_count", "unit": "lookups", "better": "higher",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["am_flat_1m.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = registry.traffic("bulk_k10")
    mix["k"] = 3
    (tmp_path / "ambench/traffic/burst.json").write_text(json.dumps(mix))
    (tmp_path / "ambench/metrics/answered_count.py").write_text(
        "def read(record):\n    return record['completed']\n")
    out = run.run_cell("am_flat_1m.burst", 11, 0.3, False, need_card=False,
                       device="cpu", config_over=_tiny("am_flat_1m"),
                       mix_over=TINY_MIX, root=tmp_path)
    assert out["correct"]
    assert out["metrics"]["answered_count"]["value"] > 0


# -- the result line ----------------------------------------------------------

@pytest.mark.parametrize("cell", ["am_flat_1m.bulk_k10", "am_ivf_1m.bulk_k10",
                                  "am_flat_1m.zipf_open",
                                  "am_flat_1m.bulk_k100"])
def test_a_cpu_run_is_correct_with_the_contract_keys(cell, root):
    out = _run(cell, root)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks" and "breakdown" not in out
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {m["name"] for m in registry.metrics(
        registry.benchmark(root), cell, False)} - {"peak_mem_gib"} \
        <= set(out["metrics"])


def test_the_indexed_cell_reads_its_index_metrics(root):
    out = _run(IVF_CELL, root, trace=True)
    assert out["correct"]
    assert out["metrics"]["ivf_candidate_pct"]["value"] > 0
    # the CPU runs the kernels' plain versions, which count no launch
    assert out["metrics"]["ivf_fine_launches_per_group"]["value"] == 0


def test_no_card_means_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "am_flat_1m.bulk_k10", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


# -- faults the check has to catch ----------------------------------------------

def _broken(res, q_valid, fault):
    """``res`` (indices, distances, exact, matched first) with ``fault``."""
    out = [None if x is None else x.clone() for x in res]
    if fault == "half_batch":
        keep = q_valid // 2                     # the rest get no answer
        out[0][keep:] = -1
        out[1][keep:] = float("inf")
        out[2][keep:] = False
        out[3][keep:] = False
    else:
        out[0][0, [0, 1]] = out[0][0, [1, 0]]   # one answer, reordered
    return out


def _plant(monkeypatch, cell, fault, root):
    """Break the path ``cell``'s window drives, where its answers are made:
    the table's batched search, or the service's dispatch of a group."""
    from repro_torch.core import am
    from repro_torch.serve.am_service import AMService
    mix = registry.cell(registry.benchmark(root), cell)["traffic"]
    if registry.traffic(mix, root)["loop"] == "batch":
        search = am.search

        def run_search(table, queries, **kw):
            r = search(table, queries, **kw)
            return am.AMSearchResult(*_broken(
                (r.indices, r.distances, r.exact, r.matched),
                queries.shape[0], fault))

        monkeypatch.setattr(am, "search", run_search)
        return
    dispatch = AMService._dispatch

    def run_dispatch(table, queries, n_valid, q_valid, *a, **kw):
        out = dispatch(table, queries, n_valid, q_valid, *a, **kw)
        return tuple(_broken(out[:4], q_valid, fault)) + tuple(out[4:])

    monkeypatch.setattr(AMService, "_dispatch", staticmethod(run_dispatch))


@pytest.mark.parametrize("cell", ["am_flat_1m.bulk_k10", "am_ivf_1m.bulk_k10",
                                  "am_flat_1m.zipf_open"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault, root):
    _plant(monkeypatch, cell, fault, root)
    out = _run(cell, root)
    assert not out["correct"]
    assert out["checks"]["mismatched_answers"]["value"] > 0


# -- the control ------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["am_flat_1m.bulk_k10", "am_ivf_1m.bulk_k10"])
def test_the_control_fails_the_check(cell, root):
    from ambench import control
    row = control.reading(cell, 3, "cpu", config_over=_tiny(cell),
                          mix_over=TINY_MIX, root=root)
    assert row["control_mismatched"] > row["limit"]
    assert row["control_mismatched"] > row["checked"] // 2


# -- the card ---------------------------------------------------------------------

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = run.run_cell("am_flat_1m.bulk_k10", 2**31 + 9, 2.0, False,
                       config_over=TINY, mix_over=TINY_MIX)
    assert out["correct"] and out["device"]["platform"] == "gpu"
