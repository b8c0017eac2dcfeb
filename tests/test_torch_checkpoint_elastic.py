"""Elastic reshard-restore on the port (mirrors test_checkpoint_elastic.py).

``reshard_restore`` must be a logical no-op: restoring a checkpoint for
any bank count of a ``LocalMesh`` (1, 2, 4, 8) yields the same full arrays,
and ``am.search_sharded`` over the restored table returns bitwise the
results of the original table, on every bank count.  In the port a bank is
a row view, so nothing needs replicating when the rows do not divide the
banks: 10 rows restore onto 4 banks as they are, and search bitwise the
reference's ``am.search`` on the same inputs.
"""

import tempfile

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import am as ref_am
from repro_torch.checkpoint import Checkpointer, reshard_restore
from repro_torch.core import am
from repro_torch.dist import LocalMesh, make_rules

torch.set_num_threads(2)

CPU = "cpu"


def _mesh(banks):
    return LocalMesh((banks,), ("model",))


def _planes(seed, rows, width=8, bits=3):
    r = np.random.default_rng(seed)
    codes = r.integers(0, 2 ** bits, (rows, width)).astype(np.int32)
    meta = r.normal(size=(rows, 2)).astype(np.float32)
    return codes, meta


def _table(seed, rows, width=8, bits=3):
    codes, meta = _planes(seed, rows, width, bits)
    return am.make_table(codes, bits=bits, meta=meta, device=CPU)


def _spec_tree(rules):
    return am.AMTable(codes=rules.am_table(), meta=rules.am_meta(),
                      care=None, bits=0, distance="hamming")


def _restore_on(t, ckpt, banks):
    mesh = _mesh(banks)
    rules = make_rules(mesh, "tp")
    template = _table(999, t.codes.shape[0], t.codes.shape[1], t.bits)
    restored, _ = reshard_restore(ckpt, template, _spec_tree(rules), mesh,
                                  device=CPU)
    return restored, mesh, rules


@settings(max_examples=8, deadline=None)
@given(rows=st.sampled_from([8, 10, 16, 24, 32]),
       pair=st.sampled_from([(1, 4), (4, 2), (4, 8), (2, 8), (8, 1)]),
       seed=st.integers(min_value=0, max_value=10_000))
def test_reshard_state_equals_original(rows, pair, seed):
    """Restored state == original, any M -> N banks."""
    _, to_banks = pair
    t = _table(seed, rows)
    with tempfile.TemporaryDirectory() as d:
        # checkpoints are logical: the writer's mesh never matters, only
        # the restore target's
        ckpt = Checkpointer(d)
        ckpt.save(1, t)
        restored, _, _ = _restore_on(t, ckpt, to_banks)
    assert torch.equal(restored.codes, t.codes)
    assert torch.equal(restored.meta, t.meta)
    assert restored.care is None and restored.bits == t.bits


@settings(max_examples=6, deadline=None)
@given(rows=st.sampled_from([10, 16, 32]),
       pair=st.sampled_from([(1, 4), (4, 2), (4, 8), (2, 1)]),
       seed=st.integers(min_value=0, max_value=10_000))
def test_search_sharded_bitwise_stable_across_reshard(rows, pair, seed):
    """search_sharded on the restored table == on the original, per bank
    count — the recovery-correctness contract the chaos harness leans on."""
    from_banks, to_banks = pair
    t = _table(seed, rows)
    r = np.random.default_rng(seed + 1)
    queries = r.integers(0, 8, (4, 8)).astype(np.int32)

    mesh0 = _mesh(from_banks)
    ref = am.search_sharded(t, queries, mesh=mesh0, k=3)

    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d)
        ckpt.save(1, t)
        restored, mesh, rules = _restore_on(t, ckpt, to_banks)
    got = am.search_sharded(restored, queries, mesh=mesh, rules=rules, k=3)
    assert torch.equal(got.indices, ref.indices)
    assert torch.equal(got.distances, ref.distances)


def test_nondivisible_rows_restore_as_they_are():
    """10 rows on 4 banks restore unchanged (a bank is a row view) and
    search bitwise the reference's am.search on the same inputs."""
    codes, meta = _planes(3, rows=10)
    t = am.make_table(codes, meta=meta, device=CPU)
    queries = np.random.default_rng(4).integers(0, 8, (3, 8)).astype(np.int32)
    want = ref_am.search(ref_am.make_table(codes, meta=meta), queries, k=2)
    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d)
        ckpt.save(1, t)
        restored, mesh, rules = _restore_on(t, ckpt, 4)
    assert torch.equal(restored.codes, t.codes)
    for merge in ("allgather", "tree", "ring"):
        got = am.search_sharded(restored, queries, mesh=mesh, rules=rules,
                                k=2, merge=merge)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(got.distances.numpy(),
                                      np.asarray(want.distances))


def test_reshard_chain_roundtrip():
    """1 -> 4 -> 2 -> 8 banks through repeated save/restore cycles stays
    lossless (the harness's repeated-reshard scenario, distilled)."""
    t = _table(7, rows=16)
    current = t
    with tempfile.TemporaryDirectory() as d:
        for step, banks in enumerate((4, 2, 8), start=1):
            ckpt = Checkpointer(d, keep=4)
            ckpt.save(step, current)
            current, _, _ = _restore_on(current, ckpt, banks)
    assert torch.equal(current.codes, t.codes)
    assert torch.equal(current.meta, t.meta)
