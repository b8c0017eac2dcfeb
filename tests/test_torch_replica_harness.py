"""The port's multi-replica fault-injection harness, under pytest.

Mirrors ``tests/test_replica_harness.py`` on
``tests/harness/torch_replica_harness.py``: the replicas are real
subprocesses that import ``repro_torch`` alone and serve on the CPU; 1
uninterrupted reference + 2 targets, >= 3 fault events over
kill/restore/reshard across ``LocalMesh`` bank counts {1, 2, 4}, every
acknowledged write recovered and every post-recovery query response
JSON-identical to the reference.
"""

import importlib.util
import json
import pathlib
import sys

import pytest

_HARNESS = (pathlib.Path(__file__).parent / "harness"
            / "torch_replica_harness.py")


def _load_harness():
    spec = importlib.util.spec_from_file_location("torch_replica_harness",
                                                  _HARNESS)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("torch_replica_harness", mod)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def harness():
    return _load_harness()


def test_trace_is_deterministic(harness):
    a = harness.make_trace(40, 2, population=32)
    b = harness.make_trace(40, 2, population=32)
    assert len(a[0]) == 40
    assert [(s, t, c.tolist(), v) for s, t, c, v in a[0]] == \
        [(s, t, c.tolist(), v) for s, t, c, v in b[0]]
    assert a[1] == b[1]


def test_full_chaos_scenario(tmp_path, harness):
    """Kill/restore/reshard x4 against a live reference: zero lost
    acknowledged writes, bitwise-equal results on every bank count."""
    log = tmp_path / "events.jsonl"
    summary = harness.run_scenario(smoke=False, log_path=str(log),
                                   device="cpu")

    assert summary["faults"] >= 3, summary
    assert summary["resharded"] >= 2, summary
    assert summary["replayed"] > 0, \
        "no kill ever caught an unacknowledged append — the replay path " \
        "went untested"
    assert summary["compared"] > 0

    events = [json.loads(line) for line in log.read_text().splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds.count("kill") == summary["faults"]
    assert kinds.count("recovered") == summary["faults"]
    # the reshard events really moved across bank counts
    banks = {e["banks"] for e in events if e["event"] == "spawn"}
    assert {1, 2, 4} <= banks, banks
    # every post-recovery burst stayed within the offered load
    bursts = [e for e in events if e["event"] == "burst_ok"]
    assert len(bursts) == summary["faults"]
