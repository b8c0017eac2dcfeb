"""The plain reference against brute-force NumPy, flat and indexed, and its
frozen partition against the program's on the same rows."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ambench.frozen import partition  # noqa: E402
from ambench.references import am_topk  # noqa: E402


def _brute(rows, queries, k, cand=None):
    """Ascending (distance, row) over the candidate rows, padded (-1, inf)."""
    idx = np.full((len(queries), k), -1)
    dist = np.full((len(queries), k), np.inf)
    for i, q in enumerate(queries):
        d = (rows != q).sum(axis=1)
        ids = np.arange(len(rows)) if cand is None else np.flatnonzero(cand[i])
        order = ids[np.lexsort((ids, d[ids]))][:k]
        idx[i, :order.size] = order
        dist[i, :order.size] = d[order]
    return idx, dist


def _table(rows, bits, index=None):
    return {"table": {"rows": rows, "bits": bits}, "index": index}


@pytest.mark.parametrize("bits,width,k", [(1, 6, 7), (3, 16, 5), (2, 8, 40)])
def test_flat_reference_is_brute_force_with_row_ties(bits, width, k):
    rng = np.random.default_rng(bits)
    rows = rng.integers(0, 1 << bits, (300, width)).astype(np.int8)
    words = rng.integers(0, 1 << bits, (37, width)).astype(np.int32)
    words[:5] = rows[:5]
    want = am_topk.expected(rows, words, _table(300, bits), k, "cpu")
    idx, dist = _brute(rows, words, k)
    assert np.array_equal(want["indices"], idx)
    assert np.array_equal(want["distances"], dist)


def test_indexed_reference_is_brute_force_over_the_probed_sets():
    bits, sets, probes = 3, 8, 3
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 8, (500, 12)).astype(np.int8)
    words = rng.integers(0, 8, (29, 12)).astype(np.int32)
    words[:4] = rows[10:14]
    index = {"sets": sets, "probes": probes, "seed": 0}
    want = am_topk.expected(rows, words, _table(500, bits, index), 6, "cpu")
    cent = partition.hyperplane_centroids(rows, sets, bits=bits, seed=0)
    d_rows = (rows[:, None, :] != cent[None]).sum(-1)
    row_set = np.array([np.lexsort((np.arange(sets), r))[0] for r in d_rows])
    d_q = (words[:, None, :] != cent[None]).sum(-1)
    probed = np.array([np.lexsort((np.arange(sets), r))[:probes] for r in d_q])
    cand = np.stack([np.isin(row_set, p) for p in probed])
    idx, dist = _brute(rows, words, 6, cand)
    assert np.array_equal(want["indices"], idx)
    assert np.array_equal(want["distances"], dist)
    sizes = np.bincount(row_set, minlength=sets)
    assert np.array_equal(want["candidate_rows"], sizes[probed].sum(axis=1))


def test_frozen_partition_is_the_programs():
    from repro_torch.index import partition as program
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 8, (3000, 32)).astype(np.int32)
    for sets in (16, 100):
        assert np.array_equal(
            partition.hyperplane_centroids(rows, sets, bits=3, seed=0),
            program.hyperplane_centroids(rows, sets, bits=3, seed=0))


def test_answers_compare_field_by_field():
    want = {"indices": np.array([[4, 2], [1, 0]]),
            "distances": np.array([[0.0, 3.0], [2.0, 2.0]])}
    good = am_topk.answers(want)
    assert am_topk.mismatched(good, want) == 0
    assert am_topk.mismatched([None, good[1]], want) == 1
    bad = am_topk.answers(want)
    bad[0].value = 2
    assert am_topk.mismatched(bad, want) == 1
    bad = am_topk.answers(want)
    bad[1].distances = np.array([2.0, 3.0])
    assert am_topk.mismatched(bad, want) == 1
