"""Port parity: repro_torch.core.am (single device) against repro.core.am.

The same numpy tables and queries go through the reference and through the
port on the CPU (``device="cpu"``).  The port's ``"cuda"`` backend there
runs the plain versions of its kernels; the reference runs its ``"ref"``
backend, or ``"pallas"`` in interpret mode where named.

Tolerance: bitwise, for indices (int32), distances (float32), exact and
matched flags, match counts and overflow flags, and table planes.
"""

import numpy as np
import pytest
import torch

from repro.core import am as jam
from repro_torch import convert
from repro_torch.core import am

torch.set_num_threads(2)

CPU = "cpu"


def _codes(seed, n, d=10, bits=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (n, d)).astype(np.int32)
    codes[4::9] = codes[2]                       # duplicate rows: ties
    return codes


def _queries(codes, seed, q=6, bits=3):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << bits, (q, codes.shape[1])).astype(np.int32)
    out[0] = codes[2]
    out[1] = codes[-1]
    return out


def _care(seed, shape):
    return (np.random.default_rng(seed).random(shape) > 0.3).astype(np.int32)


def _same_result(got, want, fields):
    for f in fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


TOPK = ("indices", "distances", "exact", "matched")
MULTI = TOPK + ("match_count", "overflow")


# ---------------------------------------------------------------------------
# table maintenance
# ---------------------------------------------------------------------------

def test_make_append_delete_touch_planes_bitwise():
    codes = _codes(0, 12)
    more = _codes(1, 3)
    care, care_more = _care(2, codes.shape), _care(3, more.shape)
    meta = jam.serving_meta(12, 5.0)
    jt = jam.make_table(codes, bits=3, meta=meta, care_mask=care)
    tt = am.make_table(codes, bits=3, meta=np.asarray(meta), care_mask=care,
                       device=CPU)
    jt = jam.append(jt, more, meta=jam.serving_meta(3, 7.0),
                    care_mask=care_more)
    tt = am.append(tt, more, meta=am.serving_meta(3, 7.0, device=CPU),
                   care_mask=care_more)
    jt = jam.delete(jt, np.array([0, 4, 13]))
    tt = am.delete(tt, np.array([0, 4, 13]))
    mask = np.zeros(jt.n_rows, bool)
    mask[[1, 2]] = True
    jt, tt = jam.delete(jt, mask), am.delete(tt, mask)
    rows = np.array([0, 3, jt.n_rows, -1], np.int32)   # sentinel + negative
    jt = jam.touch(jt, rows, 9.5)
    tt = am.touch(tt, torch.from_numpy(rows), 9.5)
    assert (tt.n_rows, tt.width, tt.bits) == (jt.n_rows, jt.width, jt.bits)
    for plane in ("codes", "meta", "care"):
        w = np.asarray(getattr(jt, plane))
        g = getattr(tt, plane).numpy()
        assert g.dtype == w.dtype, plane
        np.testing.assert_array_equal(g, w, err_msg=plane)


def test_table_validation_errors():
    codes = _codes(0, 5)
    with pytest.raises(ValueError, match="distance"):
        am.make_table(codes, distance="cosine", device=CPU)
    with pytest.raises(ValueError, match="care_mask shape"):
        am.make_table(codes, care_mask=np.ones((5, 3)), device=CPU)
    t = am.make_table(codes, device=CPU)
    with pytest.raises(ValueError, match="width"):
        am.append(t, np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="out of range"):
        am.delete(t, [-1])
    with pytest.raises(ValueError, match="timestamp meta"):
        am.touch(t, [0], 1.0)
    with pytest.raises(ValueError, match="empty"):
        am.search(am.delete(t, np.ones(5, bool)), codes[0])
    with pytest.raises(ValueError, match="query width"):
        am.search(t, np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="k= or matches="):
        am.search(t, codes[0], k=2, matches=3)


def test_backend_registry_and_alias():
    assert am.backend_names() == ("ref", "cuda", "analog", "analog_cal")
    assert am.backend_capabilities("ref") == ("dense", "masked")
    assert am.backend_capabilities("cuda") == ("dense", "fused", "masked")
    assert am.backend_capabilities("pallas") == am.backend_capabilities("cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        am.get_backend("analog_mc")
    # the port never registers into the reference's registry
    assert "cuda" not in jam.backend_names()


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("distance", ["hamming", "l1"])
@pytest.mark.parametrize("care", [False, True])
@pytest.mark.parametrize("k", [1, 5, 300])        # 300: dense tier
def test_search_matches_reference(distance, care, k):
    codes = _codes(7, 320)
    q = _queries(codes, 8)
    c = _care(9, codes.shape) if care else None
    jt = jam.make_table(codes, bits=3, distance=distance, care_mask=c)
    tt = am.make_table(codes, bits=3, distance=distance, care_mask=c,
                       device=CPU)
    am.reset_fused_fallbacks()
    for backend in ("cuda", "ref"):
        for thr, vr in [(None, None), (4.0, 250)]:
            want = jam.search(jt, q, k=k, threshold=thr, valid_rows=vr,
                              backend="ref")
            got = am.search(tt, q, k=k, threshold=thr, valid_rows=vr,
                            backend=backend)
            _same_result(got, want, TOPK)
    assert am.fused_fallbacks() == (2 if k > am.FUSED_K_MAX else 0)


@pytest.mark.parametrize("distance,care", [("hamming", True), ("l1", False)])
def test_search_matches_reference_pallas_interpret(distance, care):
    codes = _codes(11, 40, d=7)
    q = _queries(codes, 12, q=3)
    c = _care(13, codes.shape) if care else None
    jt = jam.make_table(codes, bits=3, distance=distance, care_mask=c)
    tt = am.make_table(codes, bits=3, distance=distance, care_mask=c,
                       device=CPU)
    want = jam.search(jt, q, k=4, threshold=3.0, valid_rows=30,
                      backend="pallas")
    got = am.search(tt, q, k=4, threshold=3.0, valid_rows=30,
                    backend="pallas")
    _same_result(got, want, TOPK)


@pytest.mark.parametrize("matches", [1, 4, 300])   # 300: dense multi-match
@pytest.mark.parametrize("threshold", [None, 3.0])
def test_multi_match_matches_reference(matches, threshold):
    base = _codes(21, 80, d=8)
    codes = np.concatenate([base] * 4)               # many exact matches
    care = _care(22, codes.shape)
    q = _queries(codes, 23)
    jt = jam.make_table(codes, bits=3, care_mask=care)
    tt = am.make_table(codes, bits=3, care_mask=care, device=CPU)
    want = jam.search(jt, q, matches=matches, threshold=threshold,
                      valid_rows=300, backend="ref")
    got = am.search(tt, q, matches=matches, threshold=threshold,
                    valid_rows=300, backend="cuda")
    _same_result(got, want, MULTI)
    assert got.priority_index.dtype == torch.int32


def test_single_query_squeezes_and_distances():
    codes = _codes(31, 50)
    jt = jam.make_table(codes, bits=3, distance="l1")
    tt = am.make_table(codes, bits=3, distance="l1", device=CPU)
    want = jam.search(jt, codes[7], k=3, backend="ref")
    got = am.search(tt, codes[7], k=3, backend="cuda")
    assert got.indices.shape == (3,)
    _same_result(got, want, TOPK)
    assert int(got.best_row) == int(want.best_row)
    want_m = jam.search(jt, codes[7], matches=2, threshold=1.0)
    got_m = am.search(tt, codes[7], matches=2, threshold=1.0, backend="cuda")
    assert got_m.match_count.shape == ()
    _same_result(got_m, want_m, MULTI)
    q = _queries(codes, 32)
    w = np.asarray(jam.distances(jt, q, backend="ref"))
    for backend in ("ref", "cuda"):
        g = am.distances(tt, q, backend=backend)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_convert_reproduces_reference_table():
    codes = _codes(41, 64)
    care = _care(42, codes.shape)
    jt = jam.make_table(codes, bits=3, distance="l1", care_mask=care,
                        meta=jam.serving_meta(64, 3.0))
    tt = convert.am_table_from_numpy(
        np.asarray(jt.codes), bits=jt.bits, distance=jt.distance,
        meta=np.asarray(jt.meta), care=np.asarray(jt.care), device=CPU)
    q = _queries(codes, 43)
    for plane in ("codes", "meta", "care"):
        np.testing.assert_array_equal(getattr(tt, plane).numpy(),
                                      np.asarray(getattr(jt, plane)))
    _same_result(am.search(tt, q, k=6, threshold=5.0, backend="cuda"),
                 jam.search(jt, q, k=6, threshold=5.0, backend="ref"), TOPK)


def test_thermometer_matches_reference():
    codes = _codes(51, 9, bits=3)
    np.testing.assert_array_equal(
        am.thermometer(torch.from_numpy(codes), 3).numpy(),
        np.asarray(jam.thermometer(codes, 3)))


def test_infinite_threshold_counts_each_row_once():
    """threshold=+inf: every row, masked ones included, is within it.

    The port's fused tier counts the table's rows (13 here) like the
    dense tier does.  The reference's Pallas fused tier also counts its
    block-padding rows (16 here); see ROADMAP Queue 3.
    """
    codes = _codes(61, 13, d=8)
    jt = jam.make_table(codes, bits=3)
    tt = am.make_table(codes, bits=3, device=CPU)
    want = jam.search(jt, codes[:2], matches=3, threshold=np.inf,
                      valid_rows=10, backend="ref")
    got = am.search(tt, codes[:2], matches=3, threshold=np.inf,
                    valid_rows=10, backend="cuda")
    _same_result(got, want, MULTI)
    assert got.match_count.tolist() == [13, 13]


# ---------------------------------------------------------------------------
# the tier rule, on every search path
# ---------------------------------------------------------------------------

#: ``ivf.search`` has no multi-match mode, so it runs top-k cases only.
TIER_PATHS = [(path, multi) for path in ("search", "sharded", "ivf",
                                         "service")
              for multi in (False, True) if not (path == "ivf" and multi)]


def _tier_search(path, backend, table, queries, window, multi):
    """One search of ``window`` candidates down ``path``: its result
    fields as tensors, and the service's ``fused_fallbacks`` (or None)."""
    from repro_torch.dist import LocalMesh
    from repro_torch.index import ivf
    from repro_torch.serve import AMService
    kw = (dict(matches=window, threshold=4.0) if multi
          else dict(k=window, threshold=4.0))
    if path == "service":
        svc = AMService(device=CPU)
        svc.create_table("t", width=table.width, capacity=table.n_rows,
                         backend=backend)
        svc.append("t", table.codes[:600].numpy())
        r = svc.lookup("t", queries[0].numpy(), **kw)
        out = [r.indices, r.distances, r.exact, r.matched]
        if multi:
            out += [r.match_count, r.overflow]
        return [torch.as_tensor(np.asarray(x)) for x in out], \
            svc.stats()["fused_fallbacks"]
    if path == "search":
        r = am.search(table, queries, valid_rows=600, backend=backend, **kw)
    elif path == "sharded":
        r = am.search_sharded(table, queries, mesh=LocalMesh((2,),
                                                             ("model",)),
                              valid_rows=600, backend=backend, **kw)
    else:
        index = ivf.build(table, sets=2, set_capacity=table.n_rows)
        r = ivf.search(index, queries, k=window, probes=2, threshold=4.0,
                       backend=backend).result
    return [getattr(r, f) for f in (MULTI if multi else TOPK)], None


@pytest.mark.parametrize("path,multi", TIER_PATHS)
@pytest.mark.parametrize("window", [256, 257])
def test_one_tier_rule_on_every_path(monkeypatch, path, multi, window):
    """Each search path runs the fused tier exactly where the tier rule
    says (window <= FUSED_K_MAX; 640 rows, a 2-bank mesh's bank 320 and an
    index's slab 640 clamp nothing here), counts a fallback exactly where
    the dense tier ran, and answers bitwise as the ``"cuda"`` backend."""
    real = am._BACKENDS["cuda"]
    calls = []

    def spy(tier):
        def fn(*args, **kwargs):
            calls.append(tier)
            return getattr(real, tier)(*args, **kwargs)
        return fn

    monkeypatch.setitem(am._BACKENDS, "spy", am._Backend(
        dense=spy("dense"), fused=spy("fused"), masked=real.masked,
        fused_count=real.fused_count))
    codes = _codes(71, 640)
    table = am.make_table(codes, bits=3, device=CPU)
    queries = torch.from_numpy(_queries(codes, 72))
    dense = window > am.FUSED_K_MAX
    assert am.dense_fallback("spy", window, multi=multi) == dense
    am.reset_fused_fallbacks()
    got, svc_fallbacks = _tier_search(path, "spy", table, queries, window,
                                      multi)
    assert calls and set(calls) == {"dense" if dense else "fused"}, calls
    assert am.fused_fallbacks() == int(dense)
    if path == "service":
        assert svc_fallbacks == int(dense)
    want, _ = _tier_search(path, "cuda", table, queries, window, multi)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
