"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside a fixture whether a GPU is
present and skips without one.  On a GPU machine run
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_kernels.py`` (``--noconftest``: the suite's conftest
pins JAX, which a GPU machine for the port need not have).
Tolerance: bitwise (indices, distances, counts).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import am
from repro_torch.kernels.cam_search import kernel, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("small_tile_max_q", [16, 0])
@pytest.mark.parametrize("bits,qn,n,d,care,k,valid_rows", [
    (1, 3, 700, 24, False, 256, None),
    (3, 40, 5000, 200, True, 10, 4321),
    (3, 80, 999, 16, False, 1, 3),
    (3, 16, 3000, 64, True, 10, 2999),
])
def test_kernels_bitwise_against_plain(dev, monkeypatch, small_tile_max_q,
                                       bits, qn, n, d, care, k, valid_rows):
    # 0 sends small batches to the 64-query blocks as well
    monkeypatch.setattr(kernel, "SMALL_TILE_MAX_Q", small_tile_max_q)
    rng = np.random.default_rng(n)
    t = torch.from_numpy(rng.integers(0, 1 << bits, (n, d))).to(dev)
    q = torch.from_numpy(rng.integers(0, 1 << bits, (qn, d))).to(dev)
    t[5::3] = t[1]
    q[0] = t[1]
    c = (torch.from_numpy((rng.random((n, d)) > 0.3).astype(np.int32))
         .to(dev) if care else None)
    thr = torch.full((qn, 1), float(d // 3), device=dev)
    q8, t8 = q.to(torch.int8), t.to(torch.int8)
    assert torch.equal(ops.mismatch_counts(q8, t8, bits, care=c),
                       ref.mismatch_counts(q8, t8, c))
    got = ops.topk_fused(q8, t8, k, bits, valid_rows=valid_rows, care=c,
                         count_le=thr)
    want = ref.topk(q8, t8, k, valid_rows=valid_rows, care=c, count_le=thr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_search_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 8, (3000, 64)).astype(np.int32)
    queries = codes[rng.integers(0, 3000, 33)]
    gpu = am.make_table(codes, bits=3, distance="l1")
    cpu = am.make_table(codes, bits=3, distance="l1", device="cpu")
    kernel.reset_launches()
    for k in (1, 10, 300):
        a = am.search(gpu, queries, k=k, backend="cuda", valid_rows=2900)
        b = am.search(cpu, queries, k=k, backend="cuda", valid_rows=2900)
        assert torch.equal(a.indices.cpu(), b.indices)
        assert torch.equal(a.distances.cpu(), b.distances)
    assert kernel.launches["cam_search_topk"] == 2
    assert kernel.launches["cam_search"] == 1
