"""Port parity: repro_torch.index (single device) against repro.index.

The same numpy tables and queries go through the reference and through the
port on the CPU (``device="cpu"``).  The port's ``"cuda"`` backend there
runs the plain versions of its kernels, ``"ref"`` the plain compare; the
reference runs ``"ref"``, or ``"pallas"`` in interpret mode where named.

Mirrors the single-device tests of ``tests/test_am_index.py``.
``test_search_is_jittable_with_index_as_pytree`` has no counterpart: it is
about JAX tracing (the port's index is a plain dataclass of tensors and
nothing is compiled).  The two sharded tests, ``test_sharded_bitwise_
matches_unsharded`` and ``test_service_sharded_with_index``, are mirrored
in ``tests/test_torch_sharded.py`` and
``tests/test_torch_sharded_service.py``.

Tolerance: bitwise, for the trainers' centroids, ``assign``, every plane of
a built or appended index (``set_radius`` against the reference's
(N, S)-matrix radius), and every field of a search result (indices,
distances, flags, ``recall_proxy``, ``probed_sets``,
``candidate_fraction``).  The service's mean candidate fraction is a
float32 mean whose summation order is the backend's, so it is held to
1e-6 relative.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import index as jindex
from repro.core import am as jam
from repro.index import partition as jpartition
from repro.launch import serve as ref_serve
from repro.serve import AMService as JaxService
from repro.serve import IndexSpec as JaxSpec
from repro_torch import index as tindex
from repro_torch.core import am
from repro_torch.dist import LocalMesh
from repro_torch.index import partition
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import AMService, IndexSpec

torch.set_num_threads(2)

CPU = "cpu"
PLANES = ("centroids", "slabs", "row_ids", "set_sizes", "set_radius")
RESULT = ("indices", "distances", "exact", "matched", "recall_proxy",
          "probed_sets", "candidate_fraction")


def _tables(rng, n, d, bits, distance="hamming"):
    codes = rng.integers(0, 1 << bits, size=(n, d)).astype(np.int32)
    return (jam.make_table(codes, bits=bits, distance=distance),
            am.make_table(codes, bits=bits, distance=distance, device=CPU),
            codes)


def _same(got, want, fields):
    for f in fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


def _port_backend(backend):
    return "cuda" if backend == "pallas" else backend


# ---------------------------------------------------------------------------
# build: the planes bitwise, the radius against the (N, S) matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", partition.METHODS)
@pytest.mark.parametrize("distance", ["hamming", "l1"])
def test_build_planes_bitwise(method, distance):
    rng = np.random.default_rng(1)
    jt, tt, _ = _tables(rng, 150, 12, 3, distance)
    want = jindex.build(jt, sets=7, method=method, seed=3)
    got = tindex.build(tt, sets=7, method=method, seed=3)
    _same(got, want, PLANES)
    assert (got.bits, got.distance, got.sets, got.set_capacity) == (
        want.bits, want.distance, want.sets, want.set_capacity)
    assert got.n_rows == want.n_rows == 150
    # padding capacity and its error are the reference's
    _same(tindex.build(tt, sets=7, method=method, seed=3, set_capacity=64),
          jindex.build(jt, sets=7, method=method, seed=3, set_capacity=64),
          PLANES)


# ---------------------------------------------------------------------------
# probes == sets: bitwise the flat search (and the reference)
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(backend=st.sampled_from(["ref", "pallas"]),
       distance=st.sampled_from(["hamming", "l1"]),
       bits=st.integers(1, 3), n=st.integers(2, 60), d=st.integers(1, 12),
       k=st.integers(1, 8), sets=st.integers(1, 6),
       seed=st.integers(0, 2**31 - 1))
def test_probes_all_bitwise_exact(backend, distance, bits, n, d, k, sets,
                                  seed):
    rng = np.random.default_rng(seed)
    sets = min(sets, n)
    k = min(k, n)
    jt, tt, _ = _tables(rng, n, d, bits, distance)
    jix = jindex.build(jt, sets=sets, seed=seed % 97)
    tix = tindex.build(tt, sets=sets, seed=seed % 97)
    _same(tix, jix, PLANES)
    q = rng.integers(0, 1 << bits, size=(5, d))
    want = jindex.search(jix, q, k=k, probes=sets, backend="ref")
    got = tindex.search(tix, q, k=k, probes=sets,
                        backend=_port_backend(backend))
    _same(got, want, RESULT)
    flat = am.search(tt, q, k=k, backend=_port_backend(backend))
    assert torch.equal(got.indices, flat.indices)
    assert torch.equal(got.distances, flat.distances)
    assert bool((got.recall_proxy == 1.0).all())
    assert torch.allclose(got.candidate_fraction, torch.ones(5))


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_probes_all_bitwise_on_tie_heavy_table(backend):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2, size=(40, 6))
    jt = jam.make_table(codes, bits=3, distance="l1")
    tt = am.make_table(codes, bits=3, distance="l1", device=CPU)
    q = rng.integers(0, 2, size=(7, 6))
    want = jindex.search(jindex.build(jt, sets=5, seed=1), q, k=12,
                         probes=5, backend=backend)
    got = tindex.search(tindex.build(tt, sets=5, seed=1), q, k=12, probes=5,
                        backend=_port_backend(backend))
    _same(got, want, RESULT)
    ex = am.search(tt, q, k=12, backend=_port_backend(backend))
    assert torch.equal(got.indices, ex.indices)
    assert torch.equal(got.distances, ex.distances)


def test_threshold_and_squeeze_follow_am_contract():
    rng = np.random.default_rng(3)
    jt, tt, codes = _tables(rng, 30, 8, 3)
    r = tindex.search(tindex.build(tt, sets=4), codes[7], k=3, probes=4,
                      threshold=0.5)
    assert r.indices.shape == (3,)
    assert int(r.indices[0]) == 7 and bool(r.exact[0]) and bool(r.matched[0])
    assert r.probed_sets.shape == (4,)
    assert float(r.candidate_fraction) == 1.0
    want = jindex.search(jindex.build(jt, sets=4), codes[7], k=3, probes=4,
                         threshold=0.5)
    _same(r, want, RESULT)


# ---------------------------------------------------------------------------
# approximate regime: probes < sets, bitwise the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 300])            # 300: the dense tier
def test_few_probes_bitwise_reference(k):
    rng = np.random.default_rng(4)
    jt, tt, _ = _tables(rng, 400, 10, 3)
    jix = jindex.build(jt, sets=9, method="hyperplane", seed=2)
    tix = tindex.build(tt, sets=9, method="hyperplane", seed=2)
    q = rng.integers(0, 8, size=(11, 10))
    for probes, thr in ((1, None), (3, 4.0), (9, None)):
        want = jindex.search(jix, q, k=k, probes=probes, threshold=thr,
                             backend="ref")
        for backend in ("ref", "cuda"):
            got = tindex.search(tix, q, k=k, probes=probes, threshold=thr,
                                backend=backend)
            _same(got, want, RESULT)


def _recall(r, ex):
    """Fraction of returned distances matching the exact top-k, per query."""
    return (r.distances == ex.distances).double().mean(dim=1)


def test_recall_monotonic_in_probes():
    rng = np.random.default_rng(5)
    _, tt, _ = _tables(rng, 200, 16, 3)
    idx = tindex.build(tt, sets=8, seed=2)
    q = rng.integers(0, 8, size=(12, 16))
    ex = am.search(tt, q, k=10)
    last = -1.0
    for probes in (1, 2, 4, 8):
        rec = float(_recall(tindex.search(idx, q, k=10, probes=probes),
                            ex).mean())
        assert rec >= last - 1e-9
        last = rec
    assert last == 1.0


def test_recall_proxy_is_a_sound_certificate():
    rng = np.random.default_rng(6)
    jt, tt, _ = _tables(rng, 150, 12, 3, "l1")
    jix = jindex.build(jt, sets=6, seed=3)
    tix = tindex.build(tt, sets=6, seed=3)
    q = rng.integers(0, 8, size=(20, 12))
    ex = am.search(tt, q, k=5)
    for probes in (1, 2, 3):
        r = tindex.search(tix, q, k=5, probes=probes, backend="cuda")
        proxy = r.recall_proxy
        assert bool(((proxy >= 0.0) & (proxy <= 1.0)).all())
        assert bool((proxy <= _recall(r, ex).float() + 1e-6).all())
        _same(r, jindex.search(jix, q, k=5, probes=probes), RESULT)


@pytest.mark.parametrize("method", partition.METHODS)
def test_duplicate_query_always_hits_at_one_probe(method):
    rng = np.random.default_rng(7)
    _, tt, codes = _tables(rng, 80, 10, 2)
    idx = tindex.build(tt, sets=6, method=method, seed=4)
    r = tindex.search(idx, codes[::7], k=1, probes=1, backend="cuda")
    assert bool(r.exact[:, 0].all())
    assert bool((r.distances[:, 0] == 0.0).all())


def test_candidate_fraction_counts_probed_sets():
    rng = np.random.default_rng(8)
    _, tt, _ = _tables(rng, 120, 8, 3)
    idx = tindex.build(tt, sets=6, seed=5)
    q = rng.integers(0, 8, size=(9, 8))
    r = tindex.search(idx, q, k=3, probes=2)
    sizes = idx.set_sizes.numpy()
    expect = sizes[r.probed_sets.numpy()].sum(axis=1) / sizes.sum()
    np.testing.assert_allclose(r.candidate_fraction.numpy(),
                               expect.astype(np.float32))


def test_append_extends_index_exactly():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 8, size=(90, 10))
    jix = jindex.build(jam.make_table(codes[:50], bits=3), sets=5, seed=6)
    tix = tindex.build(am.make_table(codes[:50], bits=3, device=CPU), sets=5,
                       seed=6)
    for lo, hi in ((50, 60), (60, 90)):          # the second one grows C
        jix = jindex.append(jix, codes[lo:hi])
        tix = tindex.append(tix, codes[lo:hi])
        _same(tix, jix, PLANES)
    assert tix.n_rows == 90
    assert tindex.append(tix, np.zeros((0, 10), np.int32)) is tix
    q = rng.integers(0, 8, size=(6, 10))
    r = tindex.search(tix, q, k=7, probes=5, backend="cuda")
    ex = am.search(am.make_table(codes, bits=3, device=CPU), q, k=7)
    assert torch.equal(r.indices, ex.indices)
    assert torch.equal(r.distances, ex.distances)
    _same(r, jindex.search(jix, q, k=7, probes=5), RESULT)
    # a single word and an explicit start row
    _same(tindex.append(tix, codes[3], start_row=200),
          jindex.append(jix, codes[3], start_row=200), PLANES)


# ---------------------------------------------------------------------------
# partition trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", partition.METHODS)
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_trainers_emit_valid_codes_and_assignments(method, bits):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 1 << bits, size=(50, 7))
    cent = partition.train_centroids(codes, 6, bits=bits, method=method,
                                     seed=9)
    want = jpartition.train_centroids(codes, 6, bits=bits, method=method,
                                      seed=9)
    assert cent.shape == (6, 7) and cent.dtype == np.int32
    np.testing.assert_array_equal(cent, want)
    assert cent.min() >= 0 and cent.max() < (1 << bits)
    for distance in ("hamming", "l1"):
        owner = partition.assign(cent, codes, bits=bits, distance=distance,
                                 device=CPU)
        assert owner.shape == (50,) and owner.dtype == np.int64
        np.testing.assert_array_equal(owner, jpartition.assign(
            want, codes, bits=bits, distance=distance))
        assert owner.min() >= 0 and owner.max() < 6


def test_trainers_are_deterministic():
    rng = np.random.default_rng(14)
    codes = rng.integers(0, 8, size=(40, 6))
    for method in partition.METHODS:
        a = partition.train_centroids(codes, 4, bits=3, method=method, seed=5)
        b = partition.train_centroids(torch.from_numpy(codes), 4, bits=3,
                                      method=method, seed=5)
        np.testing.assert_array_equal(a, b)


def test_unknown_partition_method_raises():
    with pytest.raises(ValueError, match="unknown partition method"):
        partition.train_centroids(np.zeros((4, 2), np.int32), 2, bits=1,
                                  method="voronoi")


# ---------------------------------------------------------------------------
# input validation
# ---------------------------------------------------------------------------

def test_search_rejects_bad_probes_and_k():
    rng = np.random.default_rng(15)
    _, tt, _ = _tables(rng, 20, 6, 2)
    idx = tindex.build(tt, sets=4)
    q = rng.integers(0, 4, size=(3, 6))
    with pytest.raises(ValueError, match="probes must be >= 1, got 0"):
        tindex.search(idx, q, probes=0)
    with pytest.raises(ValueError, match="probes=9 exceeds"):
        tindex.search(idx, q, probes=9)
    with pytest.raises(ValueError, match="k must be >= 1, got -2"):
        tindex.search(idx, q, k=-2, probes=1)
    with pytest.raises(ValueError, match="probes=9 exceeds"):
        tindex.search_sharded(idx, q, mesh=LocalMesh((2,), ("model",)),
                              probes=9)


def test_non_2d_queries_rejected_everywhere():
    rng = np.random.default_rng(16)
    _, tt, _ = _tables(rng, 20, 6, 2)
    idx = tindex.build(tt, sets=4)
    bad = rng.integers(0, 4, size=(2, 3, 6))
    with pytest.raises(ValueError, match="3-D array"):
        tindex.search(idx, bad, probes=1)
    with pytest.raises(ValueError, match="3-D array"):
        am.search(tt, bad)


def test_build_rejects_bad_shapes():
    rng = np.random.default_rng(17)
    _, tt, _ = _tables(rng, 10, 4, 2)
    with pytest.raises(ValueError, match="sets must be in"):
        tindex.build(tt, sets=11)
    idx = tindex.build(tt, sets=3)
    with pytest.raises(ValueError, match="append codes shape"):
        tindex.append(idx, np.zeros((2, 5), np.int32))
    with pytest.raises(ValueError, match="set_capacity"):
        tindex.build(tt, sets=1, set_capacity=2)
    with pytest.raises(ValueError, match="empty table"):
        tindex.build(am.make_table(np.zeros((0, 4), np.int32), device=CPU),
                     sets=1)


# ---------------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------------

def _lazy_script(svc, backend, spec_cls):
    rng = np.random.default_rng(18)
    svc.create_table("t", width=10, bits=3, capacity=256, backend=backend,
                     index=spec_cls(sets=6, probes=2))
    codes = rng.integers(0, 8, size=(100, 10))
    svc.append("t", codes[:10], values=list(range(10)))
    out = [svc.stats("t")["index"]]                 # below the threshold
    r = svc.lookup("t", codes[4], k=2)              # flat fallback
    out.append((r.hit, r.best_row, r.indices.tolist(), r.distances.tolist()))
    svc.append("t", codes[10:], values=list(range(10, 100)))
    out.append(svc.stats("t")["index"])
    for i in (0, 41, 99):                           # indexed exact hits
        r = svc.lookup("t", codes[i], k=3)
        out.append((r.hit, r.best_row, r.value, r.indices.tolist(),
                    r.distances.tolist()))
    q = rng.integers(0, 8, size=(6, 10))
    futs = [svc.submit("t", x, k=4) for x in q]
    svc.flush()
    out += [(f.result().indices.tolist(), f.result().distances.tolist())
            for f in futs]
    out.append(svc.stats("t")["index"])
    out.append(svc.stats()["index"])
    out.append(svc.stats()["compilations"])
    return out


def _close_index_stats(got, want):
    got, want = dict(got), dict(want)
    frac = got.pop("candidate_fraction"), want.pop("candidate_fraction")
    assert got == want
    assert frac[0] == pytest.approx(frac[1], rel=1e-6)


def test_service_builds_lazily_and_routes_through_index():
    got = _lazy_script(AMService(device=CPU), "cuda", IndexSpec)
    want = _lazy_script(JaxService(), "pallas", JaxSpec)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            _close_index_stats(g, w)
        else:
            assert g == w
    st0, st1, last, top = got[0], got[2], got[-3], got[-2]
    assert got[-1] == 3                              # dispatch signatures
    assert st0 is not None and not st0["built"]
    assert st1["built"] and st1["builds"] == 1
    assert last["lookups"] == 9
    assert 0.0 < last["candidate_fraction"] < 1.0
    assert top["tables"] == 1 and top["built"] == 1 and top["lookups"] == 9


def test_service_indexed_probes_all_matches_unindexed():
    rng = np.random.default_rng(19)
    codes = rng.integers(0, 8, size=(120, 8))
    svc = AMService(device=CPU)
    svc.create_table("a", width=8, capacity=512, backend="cuda",
                     index=IndexSpec(sets=5, probes=5))
    svc.create_table("b", width=8, capacity=512, backend="cuda")
    svc.append("a", codes)
    svc.append("b", codes)
    for k, q in zip((6, 6, 6, 300), rng.integers(0, 8, size=(4, 8))):
        ra, rb = svc.lookup("a", q, k=k), svc.lookup("b", q, k=k)
        assert ra.indices.shape == (k,)
        np.testing.assert_array_equal(ra.indices, rb.indices)
        np.testing.assert_array_equal(ra.distances, rb.distances)
    assert svc.stats("a")["index"]["lookups"] == 4
    assert svc.stats("b")["index"] is None
    # k = 300 > FUSED_K_MAX: each table's group counts one dense fallback,
    # the indexed one by the reference service's rule
    assert svc.stats()["fused_fallbacks"] == 2


def test_service_compaction_rebuilds_index():
    rng = np.random.default_rng(20)
    svc = AMService(device=CPU)
    svc.create_table("t", width=8, bits=2, capacity=128, backend="cuda",
                     index=IndexSpec(sets=4, probes=4, min_rows=20))
    codes = rng.integers(0, 4, size=(60, 8))
    svc.append("t", codes, values=list(range(60)))
    assert svc.stats("t")["index"]["builds"] == 1
    svc.delete("t", [0, 1, 2, 3])
    assert svc.stats("t")["index"]["builds"] == 2    # compaction rebuilt
    r = svc.lookup("t", codes[10], k=1)              # renumbered row hits
    assert r.hit and r.best_row == 6 and r.value == 10
    svc.delete("t", np.arange(40))
    assert not svc.stats("t")["index"]["built"]      # below the threshold
    assert svc.lookup("t", codes[45], k=1).hit
    with pytest.raises(ValueError, match="multi-match"):
        svc.submit("t", codes[45], matches=2)


def test_index_spec_validation():
    svc = AMService(device=CPU)
    with pytest.raises(ValueError, match="probes must be in"):
        svc.create_table("t", width=8, index=IndexSpec(sets=4, probes=0))
    with pytest.raises(ValueError, match="unknown partition method"):
        svc.create_table("t", width=8,
                         index=IndexSpec(sets=4, probes=1, method="lsh2"))
    with pytest.raises(ValueError, match="exceeds table capacity"):
        svc.create_table("t", width=8, capacity=2,
                         index=IndexSpec(sets=4, probes=1))
    with pytest.raises(ValueError, match="ternary"):
        svc.create_table("t", width=8, ternary=True, backend="cuda",
                         index=IndexSpec(sets=4, probes=1))
    assert IndexSpec(sets=8, probes=1).build_threshold == 32
    assert IndexSpec(sets=8, probes=1, min_rows=3).build_threshold == 8


def test_am_index_flags_build_an_indexed_cache():
    argv = ["--am-cache", "64", "--am-index", "4", "--am-probes", "2"]
    args = launch_serve.parse_args(argv + ["--device", CPU])
    assert (args.am_index, args.am_probes) == (4, 2)
    ref_args = ref_serve.parse_args(argv)
    assert (ref_args.am_index, ref_args.am_probes) == (4, 2)
    svc = launch_serve.build_cache_service(args, start_driver=False)
    try:
        ix = svc.stats("responses")["index"]
        assert (ix["sets"], ix["probes"], ix["built"]) == (4, 2, False)
        keys = np.random.default_rng(21).integers(
            0, 8, (20, launch_serve.CACHE_DIM)).astype(np.int32)
        svc.append("responses", keys, values=list(range(20)))
        assert svc.stats("responses")["index"]["built"]   # 20 >= 4 * 4
        for i in (0, 7, 19):
            r = svc.lookup("responses", keys[i])
            assert r.hit and r.value == i
        assert svc.stats("responses")["index"]["lookups"] == 3
    finally:
        svc.close()
