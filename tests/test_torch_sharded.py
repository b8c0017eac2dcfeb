"""Port parity: repro_torch's multi-bank search against repro's, on the CPU.

Mirrors ``tests/test_am_sharded.py`` case by case on
:class:`repro_torch.dist.LocalMesh` meshes (8 banks; (2, 2, 2) ``("pod",
"data", "model")``; (2, 4) ``("data", "model")`` with query sharding; 1
bank; 6 banks): distances hamming and l1; 37 rows over 8 banks; tie-heavy
codes; ``valid_rows`` of None, 20 and 0; the ``ref`` and ``cuda`` backends
(``cuda`` runs the plain fused version on the CPU, as ``pallas`` names it
in the reference); k = 5, 20 and 37; every merge; ``matches=`` with counts
and overflow; the all-care ternary table.  Also the merges as pure
functions, ``resolve_merge`` and ``merge_traffic_bytes`` over a grid, and
the set-banked ``ivf.search_sharded`` (``tests/test_am_index.py``'s two
sharded search tests).

Every case is held bitwise (indices, distances, flags, counts) against the
reference's single-device ``am.search`` — which the reference's own test
holds bitwise to its ``search_sharded`` — and against the port's
``am.search``.  A selection, one or more per mesh and per merge, is also
held bitwise against the reference's ``search_sharded`` itself, on
``jax.make_mesh`` over the 8 fake CPU devices of ``tests/conftest.py``:
only a selection, because the reference retraces its ``shard_map`` on
every call and one ring merge takes 13-16 s to compile on a CPU.  The
reference's jit test has no counterpart: nothing in the port is traced.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import index as jindex
from repro.core import am as jam
from repro.dist import specs as jspecs
from repro_torch import index as tindex
from repro_torch.core import am
from repro_torch.dist import LocalMesh, make_rules

torch.set_num_threads(2)

CPU = "cpu"
TOPK = ("indices", "distances", "exact", "matched")
MULTI = TOPK + ("match_count", "overflow")
MESHES = {
    "8": ((8,), ("model",)),
    "pdm": ((2, 2, 2), ("pod", "data", "model")),
    "dp": ((2, 4), ("data", "model")),
    "1": ((1,), ("model",)),
    "6": ((6,), ("model",)),
}
MERGES = ("allgather", "tree", "ring")


def _data():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 8, (37, 24)).astype(np.int32)   # 37 % 8 != 0
    ties = rng.integers(0, 2, (37, 24)).astype(np.int32)    # tie-heavy
    queries = rng.integers(0, 8, (6, 24)).astype(np.int32)
    queries[0] = codes[5]
    care = rng.integers(0, 2, (37, 24)).astype(np.int32)
    return codes, ties, queries, care


def _same(got, want, fields):
    for f in fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


def _jax_mesh(name):
    shape, axes = MESHES[name]
    if len(shape) == 1 and shape[0] < 8:
        return jax.sharding.Mesh(np.array(jax.devices()[:shape[0]]), axes)
    return jax.make_mesh(shape, axes)


# ---------------------------------------------------------------------------
# every case against the single-device search of both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_topk_sharded_matches_single_device(mesh_name, backend):
    mesh = LocalMesh(*MESHES[mesh_name])
    codes, ties, queries, _ = _data()
    for cs, distance in itertools.product((codes, ties), ("hamming", "l1")):
        jt = jam.make_table(cs, bits=3, distance=distance)
        tt = am.make_table(cs, bits=3, distance=distance, device=CPU)
        for vr, k in itertools.product((None, 20, 0), (5, 20, 37)):
            want = jam.search(jt, queries, k=k, threshold=9, valid_rows=vr)
            mine = am.search(tt, queries, k=k, threshold=9, backend=backend,
                             valid_rows=vr)
            for merge in MERGES:
                got = am.search_sharded(tt, queries, mesh=mesh, k=k,
                                        threshold=9, backend=backend,
                                        valid_rows=vr, merge=merge)
                _same(got, want, TOPK)
                _same(got, mine, TOPK)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ternary_and_multimatch_sharded_match_single_device(mesh_name):
    mesh = LocalMesh(*MESHES[mesh_name])
    _, ties, queries, care = _data()
    t_plain = am.make_table(ties, bits=3, device=CPU)
    t_allcare = am.make_table(ties, bits=3, care_mask=np.ones_like(ties),
                              device=CPU)
    t_masked = am.make_table(ties, bits=3, care_mask=care, device=CPU)
    j_plain = jam.make_table(ties, bits=3)
    j_masked = jam.make_table(ties, bits=3, care_mask=care)
    for backend, merge in itertools.product(("ref", "cuda"), MERGES):
        want = jam.search(j_plain, queries, k=5, threshold=9)
        got = am.search_sharded(t_allcare, queries, mesh=mesh, k=5,
                                threshold=9, backend=backend, merge=merge)
        _same(got, want, TOPK)
        for (jt, tt), thr, m in (((j_masked, t_masked), 3.0, 6),
                                 ((j_plain, t_plain), 24.0, 2),
                                 ((j_masked, t_masked), None, 4)):
            want = jam.search(jt, queries, matches=m, threshold=thr)
            got = am.search_sharded(tt, queries, mesh=mesh, matches=m,
                                    threshold=thr, backend=backend,
                                    merge=merge)
            _same(got, want, MULTI)
    # the M=2 / threshold=24 case overflows somewhere
    assert bool(am.search(t_plain, queries, matches=2,
                          threshold=24.0).overflow.any())


def test_dp_query_sharding_and_its_fallback():
    codes, _, queries, _ = _data()
    mesh = LocalMesh((2, 4), ("data", "model"))
    rules = make_rules(mesh, "tp")
    assert rules.dp == ("data",) and rules.tp == "model"
    assert rules.am_queries_dp() == (("data",), None)
    tt = am.make_table(codes, bits=3, device=CPU)
    jt = jam.make_table(codes, bits=3)
    for q in (queries, queries[:5]):          # Q = 5 does not divide dp 2
        for merge in MERGES:
            got = am.search_sharded(tt, q, mesh=mesh, rules=rules, k=3,
                                    threshold=9, merge=merge)
            _same(got, jam.search(jt, q, k=3, threshold=9), TOPK)


def test_single_query_and_argument_errors():
    codes, _, queries, _ = _data()
    tt = am.make_table(codes, bits=3, device=CPU)
    mesh = LocalMesh((8,), ("model",))
    got = am.search_sharded(tt, queries[0], mesh=mesh, k=4)
    _same(got, jam.search(jam.make_table(codes, bits=3), queries[0], k=4),
          TOPK)
    with pytest.raises(ValueError, match="unknown merge"):
        am.search_sharded(tt, queries, mesh=mesh, merge="mesh")
    with pytest.raises(ValueError, match="k must be >= 1"):
        am.search_sharded(tt, queries, mesh=mesh, k=0)
    with pytest.raises(ValueError, match="not both"):
        am.search_sharded(tt, queries, mesh=mesh, k=2, matches=3)
    masked = am.make_table(codes, bits=3, care_mask=np.ones_like(codes),
                           device=CPU)
    with pytest.raises(ValueError, match="masked"):
        am.search_sharded(masked, queries, mesh=mesh, backend="analog")


# ---------------------------------------------------------------------------
# a selection against the reference's own search_sharded
# ---------------------------------------------------------------------------

SELECTED = [
    ("8", "allgather", "ref", "hamming", "codes", None, 5),
    ("8", "tree", "cuda", "l1", "codes", 20, 5),
    ("8", "ring", "ref", "hamming", "ties", 0, 20),
    ("pdm", "allgather", "cuda", "l1", "ties", 20, 5),
    ("dp", "tree", "ref", "hamming", "codes", None, 5),
    ("1", "tree", "ref", "hamming", "codes", None, 5),
    ("6", "tree", "ref", "hamming", "codes", None, 37),
]


@pytest.mark.parametrize("mesh_name,merge,backend,distance,which,vr,k",
                         SELECTED)
def test_against_reference_search_sharded(mesh_name, merge, backend,
                                          distance, which, vr, k):
    codes, ties, queries, _ = _data()
    cs = codes if which == "codes" else ties
    jt = jam.make_table(cs, bits=3, distance=distance)
    tt = am.make_table(cs, bits=3, distance=distance, device=CPU)
    jmesh = _jax_mesh(mesh_name)
    want = jam.search_sharded(
        jt, queries, mesh=jmesh, rules=jspecs.make_rules(jmesh, "tp"), k=k,
        threshold=9, backend="pallas" if backend == "cuda" else backend,
        valid_rows=vr, merge=merge)
    got = am.search_sharded(tt, queries, mesh=LocalMesh(*MESHES[mesh_name]),
                            k=k, threshold=9, backend=backend,
                            valid_rows=vr, merge=merge)
    _same(got, want, TOPK)


def test_multimatch_against_reference_search_sharded():
    _, ties, queries, care = _data()
    jt = jam.make_table(ties, bits=3, care_mask=care)
    tt = am.make_table(ties, bits=3, care_mask=care, device=CPU)
    want = jam.search_sharded(jt, queries, mesh=_jax_mesh("8"), matches=6,
                              threshold=3.0, backend="pallas", merge="tree")
    got = am.search_sharded(tt, queries, mesh=LocalMesh(*MESHES["8"]),
                            matches=6, threshold=3.0, backend="cuda",
                            merge="tree")
    _same(got, want, MULTI)


# ---------------------------------------------------------------------------
# the merges as pure functions
# ---------------------------------------------------------------------------

def _candidates(seed, banks, q=5, k=4):
    """Per-bank (banks, Q, k) candidate lists, each (distance, row)-sorted,
    with ties across banks, +inf rows and sentinel padding."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 4, (banks, q, k)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.15] = np.inf
    idx = np.empty((banks, q, k), np.int32)
    for b in range(banks):
        for i in range(q):
            idx[b, i] = np.sort(rng.choice(50, k, replace=False)) + 50 * b
    order = np.lexsort((idx, dist), axis=-1)
    dist = np.take_along_axis(dist, order, -1)
    idx = np.take_along_axis(idx, order, -1)
    idx[:, :, -1:][dist[:, :, -1:] == np.inf] = am._IDX_SENTINEL
    return dist, idx


def _plain_merge(dist, idx, k):
    """The definition: the union of every bank's list, duplicates once,
    first k by (distance, row), padded with (+inf, sentinel)."""
    out_d, out_i = [], []
    for qi in range(dist.shape[1]):
        seen = {}
        for d, i in zip(dist[:, qi].ravel(), idx[:, qi].ravel()):
            if i != am._IDX_SENTINEL:
                seen[int(i)] = float(d)
        items = sorted((d, i) for i, d in seen.items())[:k]
        items += [(np.inf, am._IDX_SENTINEL)] * (k - len(items))
        out_d.append([d for d, _ in items])
        out_i.append([i for _, i in items])
    return np.array(out_d, np.float32), np.array(out_i, np.int32)


@pytest.mark.parametrize("banks", [1, 2, 3, 5, 6, 8, 9])
def test_merges_equal_the_plain_definition(banks):
    dist, idx = _candidates(banks, banks)
    mesh = LocalMesh((banks,), ("model",))
    for merge, k in itertools.product(MERGES, (1, 3, 7)):
        kl = min(k, 4)        # a bank's list is never wider than k
        d, i = dist[..., :kl], idx[..., :kl]
        gi, gd = am._merge_bank_candidates(
            torch.from_numpy(d), torch.from_numpy(i), mesh=mesh,
            axis="model", n_banks=banks, k=k, strategy=merge)
        want_d, want_i = _plain_merge(d, i, k)
        w = gd.shape[-1]      # the all-gather keeps at most banks * kl
        assert w == (min(k, banks * kl) if merge == "allgather" else k)
        assert (want_i[:, w:] == am._IDX_SENTINEL).all()
        for b in range(gi.shape[0]):        # every bank holds the result
            np.testing.assert_array_equal(gd[b].numpy(), want_d[:, :w])
            np.testing.assert_array_equal(gi[b].numpy(), want_i[:, :w])


def test_lex_merge_topk_equals_reference():
    rng = np.random.default_rng(3)
    a_d, a_i = _candidates(4, 1, q=6, k=6)
    b_d = a_d.copy()
    b_i = a_i.copy()
    b_d[0, :, ::2] = rng.integers(0, 4, (6, 3))     # some rows arrive twice
    order = np.lexsort((b_i, b_d), axis=-1)
    b_d, b_i = (np.take_along_axis(b_d, order, -1),
                np.take_along_axis(b_i, order, -1))
    for k in (1, 4, 6):
        wd, wi = jam._lex_merge_topk(a_d[0], a_i[0], b_d[0], b_i[0], k)
        gd, gi = am._lex_merge_topk(*(torch.from_numpy(x[0]) for x in
                                      (a_d, a_i, b_d, b_i)), k)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("merge", MERGES)
def test_merges_equal_reference_merges(merge):
    """The same per-bank candidates through the reference's
    ``_merge_bank_candidates`` (in its ``shard_map``) and the port's."""
    banks, k = 8, 5
    dist, idx = _candidates(7, banks, q=6, k=4)
    jmesh = jax.make_mesh((banks,), ("model",))

    def body(d, i):
        gi, gd = jam._merge_bank_candidates(d[0], i[0], axis="model",
                                            n_banks=banks, k=k,
                                            strategy=merge)
        return gi[None], gd[None]

    wi, wd = jax.shard_map(body, mesh=jmesh,
                           in_specs=(P("model"), P("model")),
                           out_specs=(P("model"), P("model")),
                           check_vma=False)(dist, idx)
    gi, gd = am._merge_bank_candidates(
        torch.from_numpy(dist), torch.from_numpy(idx),
        mesh=LocalMesh((banks,), ("model",)), axis="model", n_banks=banks,
        k=k, strategy=merge)
    gi, gd = gi.expand(banks, -1, -1), gd.expand(banks, -1, -1)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_resolve_merge_and_traffic_equal_reference():
    assert am.MERGE_STRATEGIES == jam.MERGE_STRATEGIES
    assert am.TREE_MERGE_MIN_BANKS == jam.TREE_MERGE_MIN_BANKS
    assert am.RING_MERGE_MIN_K_PER_BANK == jam.RING_MERGE_MIN_K_PER_BANK
    for banks, k in itertools.product((1, 2, 3, 8, 15, 16, 17, 64),
                                      (1, 5, 63, 64, 65, 300)):
        for merge in am.MERGE_STRATEGIES:
            assert am.resolve_merge(merge, banks, k) == jam.resolve_merge(
                merge, banks, k)
    for banks, q, k, merge, n_rows in itertools.product(
            (1, 3, 8, 16, 32), (1, 6, 1024), (1, 10, 300),
            am.MERGE_STRATEGIES, (None, 37, 1 << 20)):
        assert am.merge_traffic_bytes(banks, q, k, merge=merge,
                                      n_rows=n_rows) == \
            jam.merge_traffic_bytes(banks, q, k, merge=merge, n_rows=n_rows)
    with pytest.raises(ValueError, match="n_banks"):
        am.merge_traffic_bytes(0, 4, 4)


def _axes(spec):
    """A spec's entries with one-name tuples as the name (JAX writes
    ``P(("data",))`` as ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def test_rules_equal_reference():
    for name, (shape, axes) in MESHES.items():
        ours = make_rules(LocalMesh(shape, axes), "tp")
        ref = jspecs.make_rules(_jax_mesh(name), "tp")
        assert (ours.layout, ours.tp, ours.dp) == (ref.layout, ref.tp,
                                                   ref.dp)
        for role in ("am_table", "am_queries", "am_queries_dp", "am_meta",
                     "am_index"):
            assert _axes(getattr(ours, role)()) == _axes(
                getattr(ref, role)()), role


# ---------------------------------------------------------------------------
# the set-banked index search (tests/test_am_index.py, sharded)
# ---------------------------------------------------------------------------

def _index_pair(seed, n, d, bits, sets, build_seed, distance="hamming"):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, size=(n, d)).astype(np.int32)
    jt = jam.make_table(codes, bits=bits, distance=distance)
    tt = am.make_table(codes, bits=bits, distance=distance, device=CPU)
    return (rng, jt, tt, jindex.build(jt, sets=sets, seed=build_seed),
            tindex.build(tt, sets=sets, seed=build_seed))


IVF_FIELDS = TOPK + ("recall_proxy", "probed_sets", "candidate_fraction")


@pytest.mark.parametrize("merge", MERGES)
def test_ivf_sharded_bitwise_matches_unsharded(merge):
    rng, _, _, ji, ti = _index_pair(11, 300, 12, 3, 11, 7)  # 11 sets, 8 banks
    q = rng.integers(0, 8, size=(6, 12))
    mesh = LocalMesh((8,), ("model",))
    for probes, backend in itertools.product((1, 4, 11), ("ref", "cuda")):
        got = tindex.search_sharded(ti, q, mesh=mesh, k=9, probes=probes,
                                    merge=merge, backend=backend)
        _same(got, jindex.search(ji, q, k=9, probes=probes), IVF_FIELDS)
        _same(got, tindex.search(ti, q, k=9, probes=probes,
                                 backend=backend), IVF_FIELDS)


def test_ivf_sharded_against_reference_search_sharded():
    rng, _, _, ji, ti = _index_pair(11, 300, 12, 3, 11, 7)
    q = rng.integers(0, 8, size=(6, 12))
    want = jindex.search_sharded(ji, q, mesh=_jax_mesh("8"), k=9, probes=4,
                                 merge="allgather")
    got = tindex.search_sharded(ti, q, mesh=LocalMesh(*MESHES["8"]), k=9,
                                probes=4, merge="allgather", backend="cuda")
    _same(got, want, IVF_FIELDS)


@pytest.mark.parametrize("banks", [1, 3, 8])
def test_ivf_sharded_probes_all_matches_flat_search(banks):
    rng, jt, tt, _, ti = _index_pair(12, 200, 10, 2, 8, 8, "l1")
    q = rng.integers(0, 4, size=(5, 10))
    got = tindex.search_sharded(ti, q, mesh=LocalMesh((banks,), ("model",)),
                                k=6, probes=8, backend="cuda")
    _same(got, jam.search(jt, q, k=6), ("indices", "distances"))
    _same(got, am.search(tt, q, k=6), ("indices", "distances"))


def test_infinite_threshold_counts_each_row_once():
    """At ``threshold=+inf`` every live row counts once, as in ``search``.
    The reference's sharded dense tier also counts its bank-padding rows
    there (40 for 37 rows over 8 banks); the port has no padding rows."""
    codes, _, queries, _ = _data()
    tt = am.make_table(codes, bits=3, device=CPU)
    want = jam.search(jam.make_table(codes, bits=3), queries, matches=4,
                      threshold=float("inf"))
    for backend, merge in itertools.product(("ref", "cuda"), MERGES):
        got = am.search_sharded(tt, queries, mesh=LocalMesh(*MESHES["8"]),
                                matches=4, threshold=float("inf"),
                                backend=backend, merge=merge)
        _same(got, want, MULTI)
        assert (got.match_count == 37).all()
