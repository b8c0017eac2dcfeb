"""The port's AMService durability: snapshot / warm restart / elastic reshard.

Mirrors ``tests/test_am_snapshot.py`` on ``repro_torch.serve`` (on the
CPU, local meshes of 1-8 banks), then holds the shared on-disk format to
the reference in both directions, on the same numpy inputs:

* a snapshot the reference's ``AMService.snapshot`` writes (a plain table,
  a ternary TTL table, a table with a built IVF index and admission
  control, ``app=``) restores in the port with equal state, and every
  lookup is bitwise the reference service's; and the reverse;
* a snapshot of a 2-bank reference service restores onto the port at 1, 4
  and 8 banks, every lookup bitwise;
* both packages' manifests of the same state are equal, leaf for leaf
  (path, file, shape, dtype) and field for field;
* an append that lands after ``snapshot`` copied the tables, but before it
  wrote them, is absent from the restored table: the port's ``append``
  writes the slab in place, so the capture must copy.

Tolerance: bitwise for every response array, equality for state.
"""

import json
import pathlib
import pickle
import shutil
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.serve import AMService as JaxService
from repro.serve import IndexSpec as JaxIndexSpec
from repro_torch.dist import LocalMesh
from repro_torch.serve import (MANIFEST_FIELDS, SNAPSHOT_FORMAT, AMService,
                               IndexSpec, read_service_manifest,
                               table_manifest)
from repro_torch.serve import snapshot as snap
from repro_torch.serve.am_service import AMDriver

torch.set_num_threads(2)

CPU = "cpu"
WIDTH = 8
LEVELS = 8


def _codes(rng, n):
    return rng.integers(0, LEVELS, (n, WIDTH)).astype(np.int32)


def _mesh(banks):
    return LocalMesh((banks,), ("model",))


def _mk(mesh=None, **kw):
    svc = AMService(mesh=mesh, device=CPU, **kw)
    svc.create_table("t", width=WIDTH, capacity=64, policy="lru",
                     backend="ref")
    return svc


def _restore(d, **kw):
    return AMService.restore(d, device=CPU, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_table(a, b, name="t"):
    """Equal table state; either side may be the reference's service."""
    ta, tb = a._tables[name], b._tables[name]
    assert ta.n == tb.n and ta.capacity == tb.capacity
    assert pickle.dumps(ta.values) == pickle.dumps(tb.values)
    assert ta.version == tb.version
    for plane in ("codes", "meta", "care"):
        x, y = getattr(ta.table, plane), getattr(tb.table, plane)
        assert (x is None) == (y is None), plane
        if x is not None:
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=plane)
    assert (ta.table.bits, ta.table.distance) == \
        (tb.table.bits, tb.table.distance)
    assert (ta.policy, ta.ttl, ta.backend) == (tb.policy, tb.ttl, tb.backend)
    assert (ta.qps_budget, ta.burst, ta.max_queue, ta.admission) == \
        (tb.qps_budget, tb.burst, tb.max_queue, tb.admission)
    assert (ta.index is None) == (tb.index is None)
    if ta.index is not None:
        for k in snap.INDEX_KEYS:
            np.testing.assert_array_equal(_np(getattr(ta.index, k)),
                                          _np(getattr(tb.index, k)),
                                          err_msg=k)


def _assert_same_response(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.distances.tobytes() == b.distances.tobytes()
    np.testing.assert_array_equal(a.exact, b.exact)
    np.testing.assert_array_equal(a.matched, b.matched)
    assert a.match_count == b.match_count and a.overflow == b.overflow
    assert pickle.dumps(a.value) == pickle.dumps(b.value)


# ---------------------------------------------------------------------------
# basic round trip
# ---------------------------------------------------------------------------

def test_snapshot_restore_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    svc = _mk()
    svc.append("t", _codes(rng, 12), values=[f"v{i}" for i in range(12)])
    q = _codes(rng, 1)[0]
    ref = svc.lookup("t", q, k=3)
    step = svc.snapshot(tmp_path)
    assert step == 1

    restored = _restore(tmp_path)
    _assert_same_table(svc, restored)
    assert restored._tables["t"].table.codes.device.type == "cpu"
    got = restored.lookup("t", q, k=3)
    _assert_same_response(got, ref)


def test_snapshot_versioning_and_step_chain(tmp_path):
    rng = np.random.default_rng(1)
    svc = _mk()
    svc.append("t", _codes(rng, 4), values=list(range(4)))
    assert svc.snapshot(tmp_path) == 1
    svc.append("t", _codes(rng, 2), values=[4, 5])
    assert svc.snapshot(tmp_path) == 2
    # older committed step still restorable (keep=2)
    old = _restore(tmp_path, step=1)
    new = _restore(tmp_path)
    assert old._tables["t"].n == 4 and new._tables["t"].n == 6


def test_restore_onto_different_bank_counts(tmp_path):
    """The elastic warm restart: a 2-bank snapshot onto no mesh and 1, 4
    and 8 banks, bitwise equal search results."""
    rng = np.random.default_rng(2)
    svc = _mk(mesh=_mesh(2), merge="allgather")
    svc.append("t", _codes(rng, 10), values=list(range(10)))
    queries = _codes(rng, 5)
    refs = [svc.lookup("t", q, k=4) for q in queries]
    svc.snapshot(tmp_path)

    for banks in (None, 1, 4, 8):
        mesh = None if banks is None else _mesh(banks)
        restored = _restore(tmp_path, mesh=mesh,
                            merge="allgather" if mesh else None)
        assert restored.stats()["sharded"] == (mesh is not None)
        _assert_same_table(svc, restored)
        for q, ref in zip(queries, refs):
            _assert_same_response(restored.lookup("t", q, k=4), ref)


def test_snapshot_preserves_full_table_config(tmp_path):
    """Ternary flag, admission config, index spec + built tier, TTL policy
    and backend all survive the round trip."""
    rng = np.random.default_rng(3)
    svc = AMService(device=CPU)
    svc.create_table("idx", width=WIDTH, capacity=64,
                     index=IndexSpec(sets=4, probes=2, min_rows=4),
                     qps_budget=50.0, burst=3.0, max_queue=9,
                     admission="shed")
    svc.create_table("tern", width=WIDTH, capacity=32, ternary=True,
                     policy="ttl", ttl=100.0)
    svc.append("idx", _codes(rng, 20), values=list(range(20)))
    svc.append("tern", _codes(rng, 6), values=list(range(6)),
               care=rng.integers(0, 2, (6, WIDTH)).astype(np.int32))
    svc.lookup("idx", _codes(rng, 1)[0])      # the index is built
    assert svc._tables["idx"].index is not None
    svc.snapshot(tmp_path)

    restored = _restore(tmp_path)
    ti, tt = restored._tables["idx"], restored._tables["tern"]
    assert ti.index is not None and ti.index_spec == IndexSpec(
        sets=4, probes=2, min_rows=4)
    assert (ti.qps_budget, ti.burst, ti.max_queue, ti.admission) == \
        (50.0, 3.0, 9, "shed")
    assert tt.table.care is not None and tt.policy == "ttl" \
        and tt.ttl == 100.0
    _assert_same_table(svc, restored, "idx")
    _assert_same_table(svc, restored, "tern")


def test_restored_clock_continuity(tmp_path):
    """LRU/TTL meta written before the snapshot stays ordered against
    post-restore traffic: the restored logical clock resumes, not resets."""
    rng = np.random.default_rng(4)
    svc = _mk()
    svc.append("t", _codes(rng, 4), values=list(range(4)))
    before = float(svc._clock)
    svc.snapshot(tmp_path)
    restored = _restore(tmp_path)
    assert restored._clock >= before
    # appends after restore must get meta timestamps >= the restored rows'
    restored.append("t", _codes(rng, 1), values=[9])
    meta = restored._tables["t"].table.meta.numpy()
    assert meta[4, 0] >= meta[:4, 0].max()


# ---------------------------------------------------------------------------
# snapshot under live traffic (the trace-equivalence extension)
# ---------------------------------------------------------------------------

def test_snapshot_under_live_traffic_equals_sync_reference(tmp_path):
    """Interleaved submit/append/snapshot/restore trace: the restored
    service's state and every post-restore response are byte-identical to
    a sync-flushed reference that never snapshotted."""
    mk = lambda: _mk(max_batch=5)     # noqa: E731
    rng_a, rng_b = (np.random.default_rng(42) for _ in range(2))

    def trace(svc, rng, *, snap_after_wave=None):
        responses = []
        svc.append("t", _codes(rng, 8), values=[f"v{i}" for i in range(8)])
        drv = AMDriver(svc, max_in_flight=4)
        for wave in range(4):
            futs = [svc.submit("t", _codes(rng, 1)[0], k=3)
                    for _ in range(5)]
            drv.run_once(force=False)
            svc.append("t", _codes(rng, 4),
                       values=[f"w{wave}.{i}" for i in range(4)])
            drv.run_once(force=True)
            responses.extend(f.result() for f in futs)
            if wave == snap_after_wave:
                # snapshot drains the driver's in-flight groups itself;
                # the restored service replays the remaining waves
                svc.snapshot(tmp_path)
                svc = _restore(tmp_path)
                drv = AMDriver(svc, max_in_flight=4)
        return svc, responses

    svc_ref, ref = trace(mk(), rng_a, snap_after_wave=None)
    svc_got, got = trace(mk(), rng_b, snap_after_wave=1)

    assert len(ref) == len(got) == 20
    for rs, ra in zip(ref, got):
        _assert_same_response(rs, ra)
    _assert_same_table(svc_ref, svc_got)


def test_snapshot_includes_acknowledged_appends_in_queue(tmp_path):
    """Appends acknowledged before snapshot() are in the snapshot even when
    lookups are still pending at call time (drain retires them first)."""
    rng = np.random.default_rng(5)
    svc = _mk(max_batch=64)           # big bucket: submits queue up
    svc.append("t", _codes(rng, 8), values=list(range(8)))
    futs = [svc.submit("t", _codes(rng, 1)[0]) for _ in range(3)]
    svc.append("t", _codes(rng, 2), values=[8, 9])     # acknowledged now
    svc.snapshot(tmp_path)
    assert all(f.done for f in futs)  # drained, not dropped
    restored = _restore(tmp_path)
    assert restored._tables["t"].n == 10
    assert restored._tables["t"].values == list(range(10))


def test_concurrent_append_during_snapshot_never_torn(tmp_path):
    """Appends racing snapshot() land entirely in or entirely out: the
    restored (codes, values, n) tuple is always mutually consistent, on
    the port's in-place slabs."""
    rng = np.random.default_rng(6)
    pool = _codes(rng, 60)
    svc = _mk()
    svc.append("t", pool[:4], values=list(range(4)))
    stop = threading.Event()

    def writer():
        i = 4
        while not stop.is_set() and i < 60:
            svc.append("t", pool[i], values=[i])
            i += 1

    w = threading.Thread(target=writer)
    w.start()
    try:
        svc.snapshot(tmp_path)
    finally:
        stop.set()
        w.join(timeout=30)
    assert not w.is_alive()
    restored = _restore(tmp_path)
    t = restored._tables["t"]
    assert t.values == list(range(t.n))        # a prefix, never a tear
    codes = t.table.codes.numpy()
    assert codes.shape[0] == t.capacity
    np.testing.assert_array_equal(codes[:t.n], pool[:t.n])
    assert not codes[t.n:].any()               # no row past n leaked in


def test_append_after_capture_is_absent(tmp_path, monkeypatch):
    """An append that lands after snapshot() copied the tables but before
    it wrote them is not in the snapshot: the slab is written in place, so
    holding it (as the reference holds its immutable arrays) would tear."""
    rng = np.random.default_rng(12)
    svc = _mk()
    first = _codes(rng, 5)
    svc.append("t", first, values=list(range(5)))
    before = svc._tables["t"].table.codes.clone()
    late = _codes(rng, 3)
    save = snap.Checkpointer.save

    def save_after_an_append(self, step, tree, metadata=None):
        svc.append("t", late, values=["late"] * 3)   # lock is free here
        return save(self, step, tree, metadata)

    monkeypatch.setattr(snap.Checkpointer, "save", save_after_an_append)
    svc.snapshot(tmp_path)
    monkeypatch.setattr(snap.Checkpointer, "save", save)
    assert svc._tables["t"].n == 8                   # it did land live
    t = _restore(tmp_path)._tables["t"]
    assert t.n == 5 and t.values == list(range(5))
    assert torch.equal(t.table.codes, before)
    assert not t.table.meta[5:].any()


# ---------------------------------------------------------------------------
# manifest contract
# ---------------------------------------------------------------------------

def test_manifest_contract_fields(tmp_path):
    rng = np.random.default_rng(7)
    svc = _mk()
    svc.append("t", _codes(rng, 3), values=list(range(3)))
    svc.snapshot(tmp_path, app={"origin": "unit-test"})
    md = table_manifest(tmp_path, "t")
    assert set(md) == set(MANIFEST_FIELDS)
    assert md["format"] == SNAPSHOT_FORMAT
    assert md["table"] == "t" and md["n"] == 3 and md["capacity"] == 64
    assert md["app"] == {"origin": "unit-test"}
    service = read_service_manifest(tmp_path)
    assert service["tables"] == ["t"] and service["step"] == 1
    assert service["app"] == {"origin": "unit-test"}
    assert set(svc._last_snapshot) == {"step", "drain_capture_s", "write_s"}


def test_restore_rejects_unknown_format(tmp_path):
    rng = np.random.default_rng(8)
    svc = _mk()
    svc.append("t", _codes(rng, 2), values=[0, 1])
    svc.snapshot(tmp_path)
    sj = tmp_path / "service.json"
    doc = json.loads(sj.read_text())
    doc["format"] = 99
    sj.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="format"):
        _restore(tmp_path)


def test_restore_rejects_inconsistent_manifest(tmp_path):
    """A manifest whose n disagrees with the payload count is refused, not
    silently truncated."""
    rng = np.random.default_rng(9)
    svc = _mk()
    svc.append("t", _codes(rng, 3), values=list(range(3)))
    svc.snapshot(tmp_path)
    tdir = next((tmp_path / "tables" / "t").glob("step_*"))
    manifest = json.loads((tdir / "manifest.json").read_text())
    manifest["metadata"]["n"] = 2                   # lie about the count
    (tdir / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="inconsistent"):
        _restore(tmp_path)


def test_torn_snapshot_restores_previous_step(tmp_path):
    """A crash between a table commit and service.json leaves the previous
    committed step fully restorable (the keep>=2 invariant)."""
    rng = np.random.default_rng(10)
    svc = _mk()
    svc.append("t", _codes(rng, 4), values=list(range(4)))
    svc.snapshot(tmp_path)
    svc.append("t", _codes(rng, 2), values=[4, 5])
    # the torn write: commit the table step but "crash" before
    # service.json, by snapshotting into a scratch dir and copying only the
    # table step over
    scratch = tmp_path.parent / "scratch"
    svc.snapshot(scratch)
    src = snap._table_dir(scratch, "t") / "step_00000001"
    dst = snap._table_dir(tmp_path, "t") / "step_00000002"
    shutil.copytree(src, dst)
    # service.json still names step 1: restore sees the consistent old cut
    restored = _restore(tmp_path)
    assert restored._tables["t"].n == 4

    # keep < 2 is refused outright
    with pytest.raises(ValueError, match="keep"):
        svc.snapshot(tmp_path, keep=1)


def test_values_payloads_pickle_roundtrip(tmp_path):
    """Arbitrary picklable payloads (arrays, dicts, None) survive."""
    rng = np.random.default_rng(11)
    payloads = [np.arange(4), {"k": [1, 2]}, None]
    svc = _mk()
    svc.append("t", _codes(rng, 3), values=payloads)
    svc.snapshot(tmp_path)
    got = _restore(tmp_path)._tables["t"].values
    assert pickle.dumps(got) == pickle.dumps(payloads)


def test_restore_without_a_card_raises(tmp_path, monkeypatch):
    svc = _mk()
    svc.append("t", np.zeros((1, WIDTH), np.int32))
    svc.snapshot(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AMService.restore(tmp_path)


# ---------------------------------------------------------------------------
# the shared on-disk format, against the reference
# ---------------------------------------------------------------------------

TABLES = ("plain", "tern", "idx")


def _fill(svc, index_spec):
    """The same tables and traffic on either package's service: a plain LRU
    table (evicting), a ternary TTL table, an indexed table with admission
    control (its index built); returns the lookups to compare with."""
    rng = np.random.default_rng(21)
    svc.create_table("plain", width=WIDTH, capacity=12, policy="lru",
                     backend="ref")
    svc.create_table("tern", width=WIDTH, capacity=16, ternary=True,
                     policy="ttl", ttl=30.0, backend="ref")
    svc.create_table("idx", width=WIDTH, capacity=64, backend="ref",
                     index=index_spec(sets=4, probes=2, min_rows=8),
                     qps_budget=50.0, burst=4.0, max_queue=16,
                     admission="shed")
    pool = _codes(rng, 40)
    svc.append("plain", pool[:10], values=[f"p{i}" for i in range(10)])
    care = rng.integers(0, 2, (6, WIDTH)).astype(np.int32)
    svc.append("tern", pool[10:16], care=care, values=list(range(6)))
    svc.append("idx", pool[16:40], values=[np.arange(i) for i in range(24)])
    for i in (0, 3, 3, 7):
        svc.lookup("plain", pool[i], k=2)
    svc.append("plain", pool[30:34], values=["x", "y", "z", None])  # evicts
    svc.lookup("idx", pool[20])
    lookups = [("plain", pool[i], {"k": 3}) for i in (1, 3, 31, 33)]
    lookups += [("tern", pool[i], {"matches": 3}) for i in (10, 12, 2)]
    lookups += [("idx", pool[i], {"k": 4}) for i in (17, 25, 0)]
    return lookups


def _lookup_all(svc, lookups):
    futs = [svc.submit(name, q, **kw) for name, q, kw in lookups]
    svc.flush()
    return [f.result() for f in futs]


def _jax_mesh(banks):
    return Mesh(np.array(jax.devices()[:banks]).reshape(banks,), ("model",))


def test_reference_snapshot_restores_in_the_port(tmp_path):
    ref = JaxService()
    lookups = _fill(ref, JaxIndexSpec)
    ref.snapshot(tmp_path, app={"applied_seq": {"plain": 7}})
    ours = _restore(tmp_path)
    for name in TABLES:
        _assert_same_table(ref, ours, name)
    assert ours._clock == ref._clock
    assert read_service_manifest(tmp_path)["app"] == \
        {"applied_seq": {"plain": 7}}
    for a, b in zip(_lookup_all(ref, lookups), _lookup_all(ours, lookups)):
        _assert_same_response(a, b)


def test_port_snapshot_restores_in_the_reference(tmp_path):
    ours = AMService(device=CPU)
    lookups = _fill(ours, IndexSpec)
    ours.snapshot(tmp_path, app={"origin": "port"})
    ref = JaxService.restore(tmp_path)
    for name in TABLES:
        _assert_same_table(ours, ref, name)
    assert ref._clock == ours._clock
    for a, b in zip(_lookup_all(ours, lookups), _lookup_all(ref, lookups)):
        _assert_same_response(a, b)


def test_manifests_equal_across_packages(tmp_path):
    """Same state, same manifests: every leaf's path, file, shape and dtype,
    every metadata field, and service.json."""
    ref, ours = JaxService(), AMService(device=CPU)
    _fill(ref, JaxIndexSpec)
    _fill(ours, IndexSpec)
    ref.snapshot(tmp_path / "ref", app={"a": 1})
    ours.snapshot(tmp_path / "ours", app={"a": 1})
    assert read_service_manifest(tmp_path / "ref") == \
        read_service_manifest(tmp_path / "ours")
    for name in TABLES:
        m_ref, m_ours = (json.loads(next(pathlib.Path(
            snap._table_dir(tmp_path / side, name)).glob("step_*"))
            .joinpath("manifest.json").read_text())
            for side in ("ref", "ours"))
        assert m_ref == m_ours, name
        assert set(m_ours["metadata"]) == set(MANIFEST_FIELDS)
    files = sorted(p.relative_to(tmp_path / "ours")
                   for p in (tmp_path / "ours").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "ref")
                           for p in (tmp_path / "ref").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "ours" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f


def test_reference_two_bank_snapshot_onto_port_banks(tmp_path):
    """A snapshot of a 2-bank reference service restores onto the port at
    1, 4 and 8 banks; every lookup is bitwise the reference service's."""
    rng = np.random.default_rng(22)
    ref = JaxService(mesh=_jax_mesh(2), merge="allgather")
    ref.create_table("t", width=WIDTH, capacity=32, backend="ref")
    ref.append("t", _codes(rng, 10), values=list(range(10)))
    ref.snapshot(tmp_path)
    restored = [_restore(tmp_path, mesh=_mesh(banks), merge="allgather")
                for banks in (1, 4, 8)]
    for ours in restored:
        _assert_same_table(ref, ours)
    lookups = [("t", q, {"k": 4}) for q in _codes(rng, 4)]
    want = _lookup_all(ref, lookups)
    for ours in restored:
        assert ours.stats()["sharded"]
        for a, b in zip(want, _lookup_all(ours, lookups)):
            _assert_same_response(a, b)
