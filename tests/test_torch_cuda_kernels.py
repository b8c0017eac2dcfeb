"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside a fixture whether a GPU is
present and skips without one.  On a GPU machine run
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_kernels.py`` (``--noconftest``: the suite's conftest
pins JAX, which a GPU machine for the port need not have).
Tolerances: the CAM-search kernels bitwise (indices, distances, counts);
``hdc_encode`` the reference's (under 0.5 % of codes differ from the plain
version, none by more than one level: float32 summation order); ``mibo_mc``
rtol 1e-5, atol 1e-12 (``tests/test_kernels.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import am, mibo
from repro_torch.core import quantize as q
from repro_torch.kernels.cam_search import kernel, ops, ref
from repro_torch.kernels.hdc_encode import kernel as enc_kernel
from repro_torch.kernels.hdc_encode import ops as enc_ops
from repro_torch.kernels.hdc_encode import ref as enc_ref
from repro_torch.kernels.mibo_mc import kernel as mc_kernel
from repro_torch.kernels.mibo_mc import ops as mc_ops
from repro_torch.kernels.mibo_mc import ref as mc_ref

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


@pytest.mark.parametrize("bits", [1, 2, 3])
@pytest.mark.parametrize("b,n,d", [
    (1, 4, 16), (5, 30, 100), (8, 128, 512), (130, 617, 1024), (64, 75, 333),
])
def test_hdc_encode_against_plain(dev, bits, b, n, d):
    rng = np.random.default_rng(b + n + d + bits)
    x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(dev)
    proj = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        dev)
    enc_kernel.reset_launches()
    got = enc_ops.encode_quantize(x, proj, bits)
    assert enc_kernel.launches["hdc_encode"] == 1
    want = enc_ref.encode_quantize(x, proj, q.gaussian_thresholds(bits, dev))
    assert got.dtype == torch.int32 and got.shape == (b, d)
    diff = (got.long() - want.long()).abs()
    assert (diff != 0).double().mean().item() < 5e-3
    assert diff.max().item() <= 1
    # scaling the rows leaves the codes as they are (Z-score normalisation)
    if b <= 16 and n <= 64 and d <= 128:
        assert torch.equal(got, enc_ops.encode_quantize(3.7 * x, proj, bits))


@pytest.mark.parametrize("s,c", [(256, 32), (512, 8), (1024, 64), (100, 17)])
def test_mibo_mc_against_plain(dev, s, c):
    rng = np.random.default_rng(s + c)
    stored = torch.from_numpy(rng.integers(0, 8, c)).to(dev)
    query = torch.from_numpy(rng.integers(0, 8, c)).to(dev)
    n1, n2 = (torch.from_numpy((0.054 * rng.normal(size=(s, c))).astype(
        np.float32)).to(dev) for _ in range(2))
    mc_kernel.reset_launches()
    got = mc_ops.ml_currents_with_noise(stored, query, n1, n2)
    assert mc_kernel.launches["mibo_mc"] == 1
    v1, v2 = mibo.stored_vths(stored, 3)
    g1, g2 = mibo.search_gate_voltages(query, 3)
    want = mc_ref.ml_currents(v1[None] + n1, v2[None] + n2, g1[None],
                              g2[None])[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-12)
