"""Port parity: repro_torch.kernels.cam_search against the JAX package.

The same numpy inputs go through the reference (its ``ref`` oracles, and
its ``ops`` wrappers with the Pallas kernels in interpret mode) and through
the port on the CPU, where ``ops`` takes the plain PyTorch versions.

Tolerance: bitwise, for indices, distances, counts, flags and dtypes.
Inputs cover care planes, threshold counts, ``valid_rows`` below k,
tie-heavy tables (bits = 1, duplicate rows), k in {1, 7, 256} and ragged N.
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
    assert tkernel.launches == {"cam_search": 0, "cam_search_topk": 0}
