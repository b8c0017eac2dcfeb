"""Port parity: repro_torch.kernels.cam_search against the JAX package.

The same numpy inputs go through the reference (its ``ref`` oracles, and
its ``ops`` wrappers with the Pallas kernels in interpret mode) and through
the port on the CPU, where ``ops`` takes the plain PyTorch versions.

Tolerance: bitwise, for indices, distances, counts, flags and dtypes.
Inputs cover care planes, threshold counts, ``valid_rows`` below k,
tie-heavy tables (bits = 1, duplicate rows), k in {1, 7, 256} and ragged N.

The CUDA kernels count on bit-planes by the one-hot rule of the TPU
kernels; their plain versions (``ref.pack_planes``, ``ref.pack_care``,
``ref.plane_counts``, and ``levels=`` in ``ref.mismatch_counts`` and
``ref.topk``) are held against the Pallas kernels in interpret mode on
symbols outside ``[0, 2**bits)`` in queries and table, at levels 2, 8 and
128 and D = 16 and 48 (a half-empty last 32-symbol group).
"""

import numpy as np
import pytest
import torch

from repro.kernels.cam_search import ops as jops
from repro.kernels.cam_search import ref as jref
from repro_torch.kernels.cam_search import kernel as tkernel
from repro_torch.kernels.cam_search import ops as tops
from repro_torch.kernels.cam_search import ref as tref

torch.set_num_threads(2)


def _case(seed, bits, qn, n, d, care=False):
    rng = np.random.default_rng(seed)
    m = 1 << bits
    table = rng.integers(0, m, (n, d)).astype(np.int32)
    table[3::5] = table[1]                       # duplicate rows: ties
    queries = rng.integers(0, m, (qn, d)).astype(np.int32)
    queries[0] = table[1]
    c = (rng.random((n, d)) > 0.3).astype(np.int32) if care else None
    return queries, table, c


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _eq(got, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [1, 2, 3])
@pytest.mark.parametrize("care", [False, True])
def test_ref_mismatch_counts_bitwise(bits, care):
    q, t, c = _case(bits, bits, 7, 61, 23, care)
    _eq(tref.mismatch_counts(_t(q), _t(t), _t(c)),
        jref.mismatch_counts(q, t, c))


@pytest.mark.parametrize("k", [1, 7, 256])
@pytest.mark.parametrize("care", [False, True])
@pytest.mark.parametrize("valid_rows", [None, 4, 200])
def test_ref_topk_bitwise(k, care, valid_rows):
    q, t, c = _case(k, 1, 6, 301, 12, care)      # bits=1: ties everywhere
    want = jref.topk(q, t, k, valid_rows=valid_rows, care=c)
    got = tref.topk(_t(q), _t(t), k, valid_rows=valid_rows, care=_t(c))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_ref_topk_chunked_walk_matches_one_block(monkeypatch):
    """Row chunks fold into the same top-k as one dense block."""
    q, t, c = _case(9, 3, 5, 77, 16, True)
    thr = torch.full((5, 1), 6.0)
    whole = tref.topk(_t(q), _t(t), 10, valid_rows=70, care=_t(c),
                      count_le=thr)
    monkeypatch.setattr(tref, "_CHUNK_ELEMS", 5 * 16 * 7)   # 7-row chunks
    chunked = tref.topk(_t(q), _t(t), 10, valid_rows=70, care=_t(c),
                        count_le=thr)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert torch.equal(tref.mismatch_counts(_t(q), _t(t), _t(c)),
                       torch.from_numpy(np.array(
                           jref.mismatch_counts(q, t, c))))


@pytest.mark.parametrize("bits,qn,n,d,care", [
    (3, 9, 65, 17, False),       # every axis ragged against the TPU blocks
    (1, 4, 40, 130, True),       # D crosses the 128-block, masked
])
def test_ops_dense_helpers_bitwise(bits, qn, n, d, care):
    q, t, c = _case(n, bits, qn, n, d, care)
    got = tops.mismatch_counts(_t(q), _t(t), bits, care=_t(c))
    _eq(got, jops.mismatch_counts(q, t, bits, care=c))
    jm = np.asarray(jops.mismatch_counts(q, t, bits, care=c))
    np.testing.assert_array_equal(
        tops.exact_match(_t(q), _t(t), bits, care=_t(c)).numpy(), jm == 0)
    _eq(tops.best_row(_t(q), _t(t), bits, care=_t(c)),
        np.argmin(jm, axis=-1).astype(np.int32))
    want_i, want_d = jops.topk(q, t, 5, bits, care=c)
    got_i, got_d = tops.topk(_t(q), _t(t), 5, bits, care=_t(c))
    _eq(got_i, want_i)
    _eq(got_d, want_d)


@pytest.mark.parametrize("k,care,count,valid_rows", [
    (1, False, False, None),
    (7, True, True, 3),          # valid_rows below k: +inf rows by index
    (256, False, True, 250),     # the fused tier's largest k
])
def test_ops_topk_fused_bitwise(k, care, count, valid_rows):
    q, t, c = _case(k + 1, 1, 5, 300, 20, care)
    thr = np.array([0, 3, 5, 9, 20], np.float32) if count else None
    want = jops.topk_fused(q, t, k=k, bits=1, valid_rows=valid_rows, care=c,
                           count_le=thr)
    got = tops.topk_fused(_t(q), _t(t), k=k, bits=1, valid_rows=valid_rows,
                          care=_t(c), count_le=_t(thr))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)


def test_ops_int8_cast_and_valid_rows_clamp():
    """Symbols are cast to int8 first (256 wraps to 0), and valid_rows is
    clamped to N, as in the reference."""
    q, t, _ = _case(3, 3, 3, 20, 8)
    q = q.copy()
    q[1, :4] += 256
    want = jops.topk_fused(q, t, k=4, bits=3, valid_rows=1000)
    got = tops.topk_fused(_t(q), _t(t), k=4, bits=3,
                          valid_rows=torch.tensor(1000))
    for g, w in zip(got, want):
        _eq(g, w)


def test_kernel_wrappers_take_cuda_tensors_only():
    q = torch.zeros((2, 16), dtype=torch.int8)
    t = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.cam_search(q, t, levels=8)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.cam_search_topk(q, t, torch.tensor([4], dtype=torch.int32),
                                levels=8, k=1)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.pack_l1(q[:, :5], t[:, :5], bits=3)
    assert tkernel.launches == {"cam_search": 0, "cam_search_topk": 0,
                                "cam_search_topk_few": 0, "cam_pack": 0,
                                "cam_pack_l1": 0}


@pytest.mark.parametrize("qn,n", [
    (1, 1), (5, 2), (4096, 26), (37, 32), (4096, 32),         # few rows
    (4096, 33), (16, 129), (1024, 1_000_000), (4096, 1 << 20),
])
def test_fused_topk_takes_the_few_row_pass_up_to_32_rows(qn, n):
    """The host rule of the fused top-k's partial pass, read from the
    table's N alone: at most 32 rows take one 32-row tile in 16-query
    blocks and add a ``cam_search_topk_few`` launch beside the
    ``cam_search_topk`` one; more rows take 128-row tiles, the batch's
    query blocks and the splits they took before the few-row pass
    (``am_flat_1m``'s 1,024 x 1,000,000: 16 query tiles x 33 splits)."""
    bq, bn, splits, per, counts = tkernel._partial_plan(qn, n, 132)
    if n <= tkernel.FEW_ROWS_MAX:
        assert (bq, bn, splits, per) == (16, 32, 1, 32)
        assert counts == ("cam_search_topk", "cam_search_topk_few")
        return
    assert counts == ("cam_search_topk",)
    assert bn == 128 and bq == (16 if qn <= 16 else 64)
    assert per % 128 == 0 and (splits - 1) * per < n <= splits * per
    if (qn, n) == (1024, 1_000_000):
        assert (-(-qn // bq), splits, per) == (16, 33, 237 * 128)


def _out_of_range_case(seed, bits, qn, n, d, care=False):
    """Symbols a few values past both ends of [0, 2**bits), a third of each
    query over all of int8; one exact row, one in-range query, and query 2
    a copy of row 3 but for symbol 1, with both rules' cases at symbols 0
    and 1 (cared for)."""
    rng = np.random.default_rng(seed)
    m = 1 << bits
    table = rng.integers(-3, min(m, 125) + 3, (n, d)).astype(np.int32)
    table[2::7] = table[1]
    queries = rng.integers(-3, min(m, 125) + 3, (qn, d)).astype(np.int32)
    queries[:, : d // 3] = rng.integers(-128, 128, (qn, d // 3))
    queries[0] = table[1]
    queries[1] = rng.integers(0, m, d)
    table[3, 0] = -2
    queries[2] = table[3]
    queries[2, 1] = -5
    c = None
    if care:
        c = (rng.random((n, d)) > 0.3).astype(np.int32)
        c[3, :2] = 1
    return queries, table, c


def _i8(x):
    return None if x is None else torch.from_numpy(x).to(torch.int8)


@pytest.mark.parametrize("bits", [1, 3, 7])
@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("care", [False, True])
def test_plane_rule_matches_pallas_interpret(bits, d, care):
    """Pack and plane counts (the kernels' arithmetic, in plain PyTorch)
    and the direct one-hot rule against the Pallas cam_search."""
    q, t, c = _out_of_range_case(bits * d, bits, 5, 40, d, care)
    want = np.asarray(jops.mismatch_counts(q, t, bits, interpret=True,
                                           care=c))
    levels = 1 << bits
    qp, tp = tref.pack_planes(_i8(q), levels), tref.pack_planes(_i8(t), levels)
    cp = None if c is None else tref.pack_care(_t(c), levels)
    _eq(tref.plane_counts(qp, tp, cp, d), want)
    _eq(tref.mismatch_counts(_i8(q), _i8(t), _t(c), levels=levels), want)
    # the value rule of the reference's ref differs on these inputs
    assert not np.array_equal(
        tref.mismatch_counts(_i8(q), _i8(t), _t(c)).numpy(), want)


@pytest.mark.parametrize("bits,care,k,valid_rows", [
    (1, False, 1, None),
    (3, True, 7, 30),
    (7, True, 10, 5),            # valid_rows below k: +inf rows by index
])
def test_onehot_topk_matches_pallas_interpret(bits, care, k, valid_rows):
    q, t, c = _out_of_range_case(k, bits, 6, 40, 48, care)
    thr = np.array([0, 10, 20, 30, 40, 48], np.float32)
    want = jops.topk_fused(q, t, k=k, bits=bits, valid_rows=valid_rows,
                           interpret=True, care=c, count_le=thr)
    got = tref.topk(_i8(q), _i8(t), k, valid_rows=valid_rows, care=_t(c),
                    count_le=torch.from_numpy(thr[:, None]),
                    levels=1 << bits)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)


def test_plane_layout_and_bit_order():
    """Symbol 4i + j of a group lands at bit 8j + i of every plane; groups
    are rounded up so that rows are a multiple of four words."""
    assert tref.plane_layout(256, 8) == (3, 4, 8)
    assert tref.plane_layout(1792, 2) == (1, 2, 56)
    assert tref.plane_layout(48, 2) == (1, 2, 2)
    assert tref.plane_layout(16, 128) == (7, 8, 1)
    assert tref.plane_layout(32, 1) == (1, 2, 2)
    x = torch.zeros((1, 32), dtype=torch.int8)
    x[0, 4 * 5 + 2] = 3                      # i = 5, j = 2: bit 21
    x[0, 31] = 9                             # out of range at levels 8
    w = [int(v) & 0xFFFFFFFF for v in tref.pack_planes(x, 8)[0, 0]]
    assert w == [1 << 21 | 1 << 31, 1 << 21, 0, 0x7FFFFFFF]


def _l1_chain(codes, bits, care=False):
    """What an L1 search packed before the L1 pack kernel: the thermometer
    expansion (``am.thermometer``, its care plane repeated over the rungs),
    cast to int8 and zero-padded by ``ops``, then packed at ``levels=2``."""
    from repro_torch.core import am
    if care:
        wide = torch.repeat_interleave(codes, (1 << bits) - 1, dim=-1)
        return tref.pack_care(tops._int8(wide, True), 2)
    return tref.pack_planes(tops._int8(am.thermometer(codes, bits), True),
                            2)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("d", [1, 5, 16, 37, 4096])
@pytest.mark.parametrize("care", [False, True])
def test_pack_planes_l1_is_the_expansion_packed(bits, d, care):
    """The L1 pack's plain version: its words are those of the old chain,
    bit for bit, in-range word and zero padding included (D (2^bits - 1)
    rarely a multiple of 16 or 32), on odd Q and N, with codes over all of
    int8, so out-of-range codes saturate as ``am.thermometer`` does."""
    rng = np.random.default_rng(bits * 10_000 + d)
    q = torch.from_numpy(rng.integers(-128, 128, (3, d)).astype(np.int32))
    t = torch.from_numpy(rng.integers(-128, 128, (5, d)).astype(np.int32))
    t[1:3] = torch.from_numpy(rng.integers(0, 1 << bits, (2, d)))
    for x in (q, t):
        got = tref.pack_planes_l1(x.to(torch.int8), bits)
        assert got.shape == (x.shape[0], tref.plane_layout(
            tref.l1_width(d, bits), 2)[2], 2)
        assert torch.equal(got, _l1_chain(x, bits))
    if care:
        c = torch.from_numpy((rng.random((5, d)) > 0.4).astype(np.int32))
        assert torch.equal(tref.pack_care_l1(c.to(torch.int8), bits),
                           _l1_chain(c, bits, care=True))


def test_l1_codes_take_a_cuda_table():
    """``l1=True`` in ``ops`` is the kernels' path: a CPU table is refused
    by name, and ``am`` expands a CPU table's codes itself."""
    q = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA table"):
        tops.mismatch_counts(q, q, 3, l1=True)
    with pytest.raises(ValueError, match="CUDA table"):
        tops.topk_fused(q, q, k=1, bits=3, l1=True)
    assert tref.l1_width(5, 3) == 48 and tref.l1_width(16, 2) == 48
    assert tref.l1_width(4096, 3) == 28_672
