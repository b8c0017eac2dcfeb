"""Plain reference of an AM table's top-k lookups, flat or behind the index.

Independent of the program: distances are symbol mismatches worked out as
``width - onehot(q) . onehot(row)`` by a float32 matrix product (0/1 terms
and sums up to the width are exact in float32; TF32 is switched off all the
same), the order is ascending (distance, row id), and for an indexed table
the partition is re-derived from the stored rows: centroids by the frozen
copy of the hyperplane trainer, each row's set the nearest centroid (lowest
set id among equals), each query's probed sets the ``probes`` nearest
centroids (the same order), and the candidates every row of those sets.
It imports nothing of the program and reads nothing the program made.

``check`` compares the sampled answers of a run with it.  ``bits`` below
the configuration's gives the control: the same reference on the symbols'
top ``bits`` bits, the precision one step below the configuration's.
"""

from __future__ import annotations

import numpy as np
import torch

from ambench.frozen import partition

#: Rows of one block of the distance product.
ROW_BLOCK = 1 << 16
#: Queries of one block of the distance product.
QUERY_BLOCK = 1024
#: Key of a row that is not a candidate: after every real (distance, row).
_NO_KEY = torch.iinfo(torch.int64).max


def _onehot(x: torch.Tensor, levels: int) -> torch.Tensor:
    m, d = x.shape
    return torch.nn.functional.one_hot(x.long(), levels).reshape(
        m, d * levels).to(torch.float32)


def _mismatches(q1: torch.Tensor, r1: torch.Tensor, width: int
                ) -> torch.Tensor:
    """(Q, B) int64 mismatches from one-hot queries and rows."""
    return (width - (q1 @ r1.T).round()).to(torch.int64)


def _nearest(words: torch.Tensor, table: torch.Tensor, levels: int,
             take: int) -> torch.Tensor:
    """(M, take) ids of each word's ``take`` nearest table rows, ascending
    (distance, id)."""
    t1 = _onehot(table, levels)
    n = table.shape[0]
    out = []
    for s in range(0, words.shape[0], ROW_BLOCK):
        d = _mismatches(_onehot(words[s:s + ROW_BLOCK], levels), t1,
                        table.shape[1])
        key = d * n + torch.arange(n, device=d.device)
        out.append(torch.topk(key, take, dim=1, largest=False).values % n)
    return torch.cat(out)


def topk(rows: torch.Tensor, queries: torch.Tensor, k: int, levels: int,
         probe_mask: torch.Tensor | None = None, row_set=None):
    """((Q, k) int64 row ids, (Q, k) float64 distances) of the k nearest
    candidate rows, ascending (distance, row id); missing entries are
    (-1, inf).  Without ``probe_mask`` every row is a candidate; with it,
    row r is a candidate of query q where ``probe_mask[q, row_set[r]]``."""
    n, width = rows.shape
    dev = rows.device
    best = torch.full((queries.shape[0], k), _NO_KEY, dtype=torch.int64,
                      device=dev)
    for s in range(0, n, ROW_BLOCK):
        r1 = _onehot(rows[s:s + ROW_BLOCK], levels)
        ids = torch.arange(s, s + r1.shape[0], device=dev)
        for a in range(0, queries.shape[0], QUERY_BLOCK):
            d = _mismatches(_onehot(queries[a:a + QUERY_BLOCK], levels), r1,
                            width)
            key = d * n + ids
            if probe_mask is not None:
                allowed = probe_mask[a:a + QUERY_BLOCK][:, row_set[ids]]
                key = torch.where(allowed, key, _NO_KEY)
            both = torch.cat([best[a:a + QUERY_BLOCK], key], dim=1)
            best[a:a + QUERY_BLOCK] = torch.topk(
                both, min(k, both.shape[1]), dim=1, largest=False).values
    found = best != _NO_KEY
    idx = torch.where(found, best % n, -1)
    dist = torch.where(found, (best // n).to(torch.float64), torch.inf)
    return idx, dist


def expected(stored: np.ndarray, words: np.ndarray, config: dict, k: int,
             device, bits: int | None = None) -> dict:
    """The reference's answers to ``words`` against the ``stored`` rows.

    Returns ``indices`` (Q, k), ``distances`` (Q, k) and, for an indexed
    table, ``candidate_rows`` (Q,): the rows of each query's probed sets.
    """
    table = config["table"]
    bits = table["bits"] if bits is None else bits
    shift = table["bits"] - bits
    levels = 1 << bits
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows = torch.from_numpy(np.asarray(stored) >> shift).to(device)
        q = torch.from_numpy(np.asarray(words) >> shift).to(device)
        index = config.get("index")
        if index is None:
            idx, dist = topk(rows, q, k, levels)
            return {"indices": idx.cpu().numpy(),
                    "distances": dist.cpu().numpy()}
        cent = torch.from_numpy(partition.hyperplane_centroids(
            np.asarray(stored) >> shift, index["sets"], bits=bits,
            seed=index["seed"])).to(device)
        row_set = _nearest(rows, cent, levels, 1)[:, 0]
        probed = _nearest(q, cent, levels, index["probes"])
        mask = torch.zeros((q.shape[0], index["sets"]), dtype=torch.bool,
                           device=device).scatter_(1, probed, True)
        sizes = torch.bincount(row_set, minlength=index["sets"])
        idx, dist = topk(rows, q, k, levels, mask, row_set)
        return {"indices": idx.cpu().numpy(), "distances": dist.cpu().numpy(),
                "candidate_rows": sizes[probed].sum(dim=1).cpu().numpy()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mismatched(answers: list, want: dict) -> int:
    """How many answers differ from the reference: row ids, distances, the
    exact and matched flags (a distance of 0; no threshold is sent) and the
    payload of an exact hit (the row id)."""
    bad = 0
    for i, a in enumerate(answers):
        idx, dist = want["indices"][i], want["distances"][i]
        exact = dist == 0
        ok = (a is not None
              and np.array_equal(np.asarray(a.indices, np.int64), idx)
              and np.array_equal(np.asarray(a.distances, np.float64), dist)
              and np.array_equal(np.asarray(a.exact), exact)
              and np.array_equal(np.asarray(a.matched), exact)
              and a.value == (int(idx[0]) if exact[0] else None))
        bad += not ok
    return bad


def check(inputs, config: dict, mix: dict, items: list, device,
          bits: int | None = None) -> dict:
    """Hold the sampled (key, answer) pairs of a run to the reference.

    Returns ``mismatched`` (answers that differ, a missing one included)
    and ``facts`` the metric readers may use: for an indexed table the mean
    of the sampled queries' candidate rows.
    """
    if not items:
        return {"mismatched": 0, "facts": {}}
    keys = np.array([k for k, _ in items], np.int64)
    want = expected(inputs.stored, inputs.words[keys], config, mix["k"],
                    device, bits)
    facts = {}
    if "candidate_rows" in want:
        facts["candidate_rows_mean"] = float(want["candidate_rows"].mean())
    return {"mismatched": mismatched([a for _, a in items], want),
            "facts": facts}


class Answer:
    """An answer in the service's shape, made from reference arrays."""

    def __init__(self, indices, distances):
        self.indices = np.asarray(indices, np.int64)
        self.distances = np.asarray(distances, np.float64)
        self.exact = self.distances == 0
        self.matched = self.exact
        self.value = int(self.indices[0]) if self.exact[0] else None


def answers(want: dict) -> list:
    """The reference's arrays as one :class:`Answer` per query."""
    return [Answer(i, d) for i, d in zip(want["indices"], want["distances"])]
