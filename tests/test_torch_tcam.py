"""Port parity: repro_torch.tcam against repro.tcam.

Mirrors the 14 tests of ``tests/test_tcam.py``.  The mask helpers are
host-side numpy in both packages and are compared bitwise (codes, care
planes, entry lists, errors).  Routing tables built from the same routes
are compared plane by plane, and every lookup's hops and
``AMMultiMatchResult`` fields bitwise against the reference's on the same
addresses: the port on the CPU (``device="cpu"``) with its ``"ref"`` and
``"cuda"`` backends (the latter runs the kernels' plain versions there),
the reference with ``"ref"`` and, where named, ``"pallas"`` in interpret
mode as its own tests run it.  Hops are also held to ``lpm_oracle``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import tcam as jtcam
from repro.core import am as jam
from repro.tcam import masks as jmasks
from repro_torch import tcam
from repro_torch.core import am
from repro_torch.tcam import masks

torch.set_num_threads(2)

CPU = "cpu"
MULTI = ("indices", "distances", "exact", "matched", "match_count",
         "overflow")


def _matches(entry, value, width, bits):
    code, care = entry
    q = masks.int_to_code(value, width=width, bits=bits)
    return bool(np.all((q == code) | (care == 0)))


def _match_set(entries, width, bits):
    return {v for v in range(1 << (width * bits))
            if any(_matches(e, v, width, bits) for e in entries)}


def _same_entries(got, want):
    assert len(got) == len(want)
    for (gc, gm), (wc, wm) in zip(got, want):
        for g, w in ((gc, wc), (gm, wm)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _same_result(got, want):
    for f in MULTI:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


def _ref_routes(routes):
    """The same rules as the reference's own Route instances."""
    return [jtcam.Route(r.value, r.prefix_bits, r.next_hop) for r in routes]


def _both_tables(routes, **kw):
    jrt = jtcam.build_routing_table(_ref_routes(routes), **kw)
    trt = tcam.build_routing_table(routes, device=CPU, **kw)
    for plane in ("codes", "care"):
        np.testing.assert_array_equal(getattr(trt.table, plane).numpy(),
                                      np.asarray(getattr(jrt.table, plane)))
    for f in ("next_hops", "prefix_lens"):
        g, w = getattr(trt, f), np.asarray(getattr(jrt, f))
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    assert (trt.default_hop, trt.width, trt.bits) == (
        jrt.default_hop, jrt.width, jrt.bits)
    return jrt, trt


def _same_lookup(jrt, trt, addrs, matches, backends=("ref",)):
    """Port lookups (ref and cuda) against the reference's on each of
    ``backends``; returns the port's hops and result."""
    out = None
    for jb in backends:
        jh, jres = jtcam.lookup(jrt, addrs, matches=matches, backend=jb)
        for tb in ("ref", "cuda"):
            th, tres = tcam.lookup(trt, addrs, matches=matches, backend=tb)
            assert th.dtype == torch.int32
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            _same_result(tres, jres)
            out = th, tres
    return out


# ---------------------------------------------------------------------------
# masks: encoding + exact coverage, bitwise the reference
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(width=st.integers(1, 6), bits=st.integers(1, 4),
       seed=st.integers(0, 2**31 - 1))
def test_int_code_roundtrip(width, bits, seed):
    rng = np.random.default_rng(seed)
    for v in rng.integers(0, 1 << (width * bits), 10).tolist():
        code = masks.int_to_code(v, width=width, bits=bits)
        assert code.shape == (width,) and code.dtype == np.int32
        np.testing.assert_array_equal(
            code, jmasks.int_to_code(v, width=width, bits=bits))
        assert masks.code_to_int(code, bits=bits) == v


def test_encoding_is_big_endian():
    np.testing.assert_array_equal(
        masks.int_to_code(0xAB, width=4, bits=2), [2, 2, 2, 3])
    assert masks.code_to_int([2, 2, 2, 3], bits=2) == 0xAB


def test_encoding_validation():
    for mod in (masks, jmasks):
        with pytest.raises(ValueError, match="out of range"):
            mod.int_to_code(1 << 8, width=4, bits=2)
        with pytest.raises(ValueError, match="out of range"):
            mod.code_to_int([4, 0], bits=2)
        with pytest.raises(ValueError, match="width"):
            mod.int_to_code(0, width=0, bits=2)


@settings(max_examples=20, deadline=None)
@given(width=st.integers(1, 4), bits=st.integers(1, 3),
       seed=st.integers(0, 2**31 - 1))
def test_range_cover_is_exact(width, bits, seed):
    rng = np.random.default_rng(seed)
    space = 1 << (width * bits)
    lo, hi = sorted(rng.integers(0, space, 2).tolist())
    entries = masks.range_to_entries(lo, hi, width=width, bits=bits)
    _same_entries(entries, jmasks.range_to_entries(lo, hi, width=width,
                                                   bits=bits))
    assert _match_set(entries, width, bits) == set(range(lo, hi + 1))
    assert len(entries) <= 2 * width * ((1 << bits) - 1)


@settings(max_examples=20, deadline=None)
@given(width=st.integers(1, 4), bits=st.integers(1, 3),
       p_raw=st.integers(0, 1 << 12), v_raw=st.integers(0, 1 << 12))
def test_prefix_entries_cover_exactly(width, bits, p_raw, v_raw):
    total = width * bits
    p = p_raw % (total + 1)
    v = v_raw % (1 << total)
    entries = masks.prefix_entries(v, p, width=width, bits=bits)
    _same_entries(entries, jmasks.prefix_entries(v, p, width=width,
                                                 bits=bits))
    host = total - p
    base = (v >> host) << host
    assert _match_set(entries, width, bits) == set(range(base,
                                                         base + (1 << host)))
    if p % bits == 0:
        assert len(entries) == 1
    else:
        assert len(entries) <= 1 << (bits - 1)


def test_prefix_entry_symbol_alignment_contract():
    code, care = masks.prefix_entry(0xAB, 4, width=4, bits=2)
    np.testing.assert_array_equal(code, [2, 2, 0, 0])
    np.testing.assert_array_equal(care, [1, 1, 0, 0])
    _same_entries([(code, care)],
                  [jmasks.prefix_entry(0xAB, 4, width=4, bits=2)])
    with pytest.raises(ValueError, match="symbol-aligned"):
        masks.prefix_entry(0xAB, 3, width=4, bits=2)
    with pytest.raises(ValueError, match="prefix_bits"):
        masks.prefix_entry(0, 9, width=4, bits=2)


def test_range_validation():
    with pytest.raises(ValueError, match="empty"):
        masks.range_to_entries(5, 4, width=4, bits=2)
    with pytest.raises(ValueError, match="out of range"):
        masks.range_to_entries(0, 1 << 8, width=4, bits=2)


def test_entries_searchable_through_am():
    """The (code, care) pairs drive a real masked search: distance 0 on
    covered values, > 0 otherwise, as the reference's search says."""
    entries = masks.range_to_entries(10, 53, width=3, bits=2)
    codes = np.stack([c for c, _ in entries])
    cares = np.stack([c for _, c in entries])
    t = am.make_table(codes, bits=2, care_mask=cares, device=CPU)
    jt = jam.make_table(codes, bits=2, care_mask=cares)
    q = np.stack([masks.int_to_code(v, width=3, bits=2) for v in range(64)])
    want = jam.search(jt, q, matches=len(entries))
    for backend in ("ref", "cuda"):
        r = am.search(t, q, matches=len(entries), backend=backend)
        _same_result(r, want)
        covered = (r.match_count > 0).numpy()
        np.testing.assert_array_equal(covered, (np.arange(64) >= 10)
                                      & (np.arange(64) <= 53))


# ---------------------------------------------------------------------------
# routing: LPM by CAM priority == the pure-python oracle == the reference
# ---------------------------------------------------------------------------

ROUTES = [
    tcam.Route(0b10100000, 3, 1),
    tcam.Route(0b10110000, 4, 2),
    tcam.Route(0b10110000, 4, 9),      # duplicate: first-added must win
    tcam.Route(0b00000000, 1, 3),
    tcam.Route(0b11000000, 2, 4),
    tcam.Route(0, 0, 7),               # default route as a rule
    tcam.Route(0b10111100, 7, 5),      # sub-symbol for 2-bit cells
]


@pytest.mark.parametrize("width,bits", [(4, 2), (8, 1), (2, 4)])
def test_lookup_agrees_with_oracle_exhaustively(width, bits):
    jrt, trt = _both_tables(ROUTES, width=width, bits=bits, default_hop=-1)
    addrs = np.arange(256)
    hops, res = _same_lookup(jrt, trt, addrs, 8, backends=("ref", "pallas"))
    want = [tcam.lpm_oracle(ROUTES, a, width=width, bits=bits,
                            default_hop=-1) for a in addrs.tolist()]
    assert hops.tolist() == want
    assert want == [jtcam.lpm_oracle(_ref_routes(ROUTES), a, width=width, bits=bits,
                                     default_hop=-1)
                    for a in addrs.tolist()]
    assert bool(res.matched[:, 0].all())   # rule 0/0 covers all


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_routes=st.integers(1, 24))
def test_random_routing_tables_match_oracle(seed, n_routes):
    rng = np.random.default_rng(seed)
    width, bits = 4, 2
    total = width * bits
    routes = [tcam.Route(int(rng.integers(0, 1 << total)),
                         int(rng.integers(0, total + 1)),
                         i) for i in range(n_routes)]
    jrt, trt = _both_tables(routes, width=width, bits=bits, default_hop=-99)
    addrs = rng.integers(0, 1 << total, 64)
    hops, _ = _same_lookup(jrt, trt, addrs, 16)
    want = [tcam.lpm_oracle(routes, a, width=width, bits=bits,
                            default_hop=-99) for a in addrs.tolist()]
    assert hops.tolist() == want


def test_no_match_returns_default_hop():
    routes = [tcam.Route(0b11110000, 4, 1)]
    jrt, trt = _both_tables(routes, width=4, bits=2, default_hop=-5)
    hops, res = _same_lookup(jrt, trt, [0, 0b11110001], 4,
                             backends=("ref", "pallas"))
    assert hops.tolist() == [-5, 1]
    assert not bool(res.matched[0].any())
    assert int(res.match_count[0]) == 0


def test_rows_sorted_longest_prefix_first():
    jrt, trt = _both_tables(ROUTES, width=4, bits=2)
    lens = trt.prefix_lens.numpy()
    assert (np.diff(lens) <= 0).all()
    hops, res = _same_lookup(jrt, trt, [0b10110101], 8)
    pi = int(res.priority_index[0])
    assert int(lens[pi]) == max(
        r.prefix_bits for r in ROUTES
        if (0b10110101 >> (8 - r.prefix_bits)) == (r.value >>
                                                   (8 - r.prefix_bits)))


def test_overflow_still_resolves_correct_hop():
    jrt, trt = _both_tables(ROUTES, width=4, bits=2)
    hops, res = _same_lookup(jrt, trt, [0b10110101], 2)
    assert bool(res.overflow[0])
    assert int(hops[0]) == tcam.lpm_oracle(ROUTES, 0b10110101, width=4,
                                           bits=2)


def test_build_validation():
    with pytest.raises(ValueError, match="at least one"):
        tcam.build_routing_table([], width=4, bits=2, device=CPU)
    # plain triples work in place of Route instances
    rt = tcam.build_routing_table([(0, 0, 42)], width=4, bits=2, device=CPU)
    hops, _ = tcam.lookup(rt, [5], matches=1, backend="cuda")
    assert int(hops[0]) == 42
    q = tcam.encode_addresses(rt, [5, 0xFF])
    assert q.dtype == torch.int32 and q.shape == (2, 4)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jtcam.encode_addresses(
            jtcam.build_routing_table([(0, 0, 42)], width=4, bits=2),
            [5, 0xFF])))
