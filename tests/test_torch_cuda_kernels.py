"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside a fixture whether a GPU is
present and skips without one.  On a GPU machine run
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_kernels.py`` (``--noconftest``: the suite's conftest
pins JAX, which a GPU machine for the port need not have).
Tolerances: the CAM-search kernels and their pack kernel bitwise
(indices, distances, counts, plane words), also on symbols outside
``[0, levels)`` against the plain one-hot rule;
``hdc_encode`` the reference's (under 0.5 % of codes differ from the plain
version, none by more than one level: float32 summation order), and at
path-scale shapes at most ``ENCODE_FP32_FRACTION`` of codes differ (the
3xTF32 product is float32-accurate; a single TF32 product fails); ``mibo_mc``
rtol 1e-5, atol 1e-12 (``tests/test_kernels.py``); ``flash_attention``
2e-5 in float32 and 3e-2 in bfloat16 (``tests/test_flash_attention.py``),
in bfloat16 also each row at a relative L2 error of 2e-2.
"""

import dataclasses


import numpy as np
import pytest
import torch

from repro_torch import tcam
from repro_torch.configs.registry import get_config
from repro_torch.core import am, mibo
from repro_torch.index import ivf
from repro_torch.core import quantize as q
from repro_torch.kernels.cam_search import kernel, ops, ref
from repro_torch.kernels.flash_attention import kernel as fl_kernel
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.flash_attention import ref as fl_ref
from repro_torch.kernels.hdc_encode import kernel as enc_kernel
from repro_torch.kernels.hdc_encode import ops as enc_ops
from repro_torch.kernels.hdc_encode import ref as enc_ref
from repro_torch.kernels.mibo_mc import kernel as mc_kernel
from repro_torch.kernels.mibo_mc import ops as mc_ops
from repro_torch.kernels.mibo_mc import ref as mc_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("small_tile_max_q", [16, 0])
@pytest.mark.parametrize("bits,qn,n,d,care,counted,k,valid_rows,l1", [
    (1, 3, 700, 24, False, True, 256, None, False),
    (3, 40, 5000, 200, True, True, 10, 4321, False),
    (3, 80, 999, 16, False, True, 1, 3, False),
    (3, 16, 3000, 64, True, True, 10, 2999, False),
    # k > 32, the lists merged: splits of two or three tiles (hundreds of
    # splits), whose first tile offers all 128 rows to an open list (more
    # than k where k < 128); valid_rows inside a split
    (3, 16, 200_000, 64, False, False, 100, None, False),
    (3, 40, 70_000, 48, True, True, 33, 65_432, False),
    (1, 24, 150_000, 32, True, False, 64, 100_001, False),
    (3, 130, 60_000, 128, False, True, 128, 59_999, False),
    (7, 8, 100_000, 96, False, False, 256, 77_777, False),
    (3, 64, 90_000, 64, True, True, 256, None, False),
    # at most 32 rows: the few-row pass (one 32-row tile, 16-query blocks,
    # Q no multiple of 16), k = 1 and k = N, valid_rows below N
    (1, 37, 1, 24, False, False, 1, None, False),
    (3, 20, 2, 64, True, True, 2, 1, False),
    (3, 50, 26, 200, False, False, 1, None, False),
    (7, 33, 26, 96, True, True, 26, 20, False),
    (1, 17, 32, 48, False, True, 32, 31, False),
    (3, 64, 32, 128, True, False, 5, None, False),
    # 33 rows: the 128-row pass, k = N above 32 (the merge) and k = 1
    (3, 40, 33, 64, False, True, 33, 30, False),
    (7, 45, 33, 64, True, False, 1, None, False),
    # the HDC cell's L1 search (26 class rows of 4,096 3-bit codes, here
    # 100 queries), and with a care plane and a count at k = N
    (3, 100, 26, 4096, False, False, 1, None, True),
    (3, 70, 26, 4096, True, True, 26, 25, True),
])
def test_kernels_bitwise_against_plain(dev, monkeypatch, small_tile_max_q,
                                       bits, qn, n, d, care, counted, k,
                                       valid_rows, l1):
    # 0 sends small batches to the 64-query blocks as well (tables of more
    # than kernel.FEW_ROWS_MAX rows; the few-row pass takes 16 always)
    monkeypatch.setattr(kernel, "SMALL_TILE_MAX_Q", small_tile_max_q)
    rng = np.random.default_rng(n)
    t = torch.from_numpy(rng.integers(0, 1 << bits, (n, d))).to(dev)
    q = torch.from_numpy(rng.integers(0, 1 << bits, (qn, d))).to(dev)
    t[5::3] = t[min(1, n - 1)]
    q[0] = t[min(1, n - 1)]
    c = (torch.from_numpy((rng.random((n, d)) > 0.3).astype(np.int32))
         .to(dev) if care else None)
    thr = (torch.full((qn, 1), float(d // 3), device=dev) if counted
           else None)
    q8, t8 = q.to(torch.int8), t.to(torch.int8)
    # plain: an L1 search counts on the codes' thermometer expansion
    pq, pt, pc = q8, t8, c
    if l1:
        pq, pt = (am.thermometer(x, bits).to(torch.int8) for x in (q, t))
        pc = (None if c is None else
              torch.repeat_interleave(c, (1 << bits) - 1, dim=-1))
    assert torch.equal(ops.mismatch_counts(q8, t8, bits, care=c, l1=l1),
                       ref.mismatch_counts(pq, pt, pc))
    kernel.reset_launches()
    got = ops.topk_fused(q8, t8, k, bits, valid_rows=valid_rows, care=c,
                         count_le=thr, l1=l1)
    assert kernel.launches["cam_search_topk"] == 1
    assert kernel.launches["cam_search_topk_few"] == int(
        n <= kernel.FEW_ROWS_MAX)
    want = ref.topk(pq, pt, k, valid_rows=valid_rows, care=pc, count_le=thr)
    assert len(got) == len(want) == (3 if counted else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("small_tile_max_q", [16, 0])
@pytest.mark.parametrize("bits", [1, 3, 7])
@pytest.mark.parametrize("d,care", [(16, False), (48, True), (48, False)])
def test_kernels_follow_the_onehot_rule(dev, monkeypatch, small_tile_max_q,
                                        bits, d, care):
    """Out-of-range symbols in queries and table: the pack kernel against
    its plain version, both search kernels against the one-hot rule."""
    monkeypatch.setattr(kernel, "SMALL_TILE_MAX_Q", small_tile_max_q)
    rng = np.random.default_rng(bits * d)
    m = 1 << bits
    t = rng.integers(-3, min(m, 125) + 3, (1500, d))
    q = rng.integers(-3, min(m, 125) + 3, (20, d))
    q[:, : d // 3] = rng.integers(-128, 128, (20, d // 3))
    t[2::7] = t[1]
    q[0] = t[1]
    t8 = torch.from_numpy(t).to(dev).to(torch.int8)
    q8 = torch.from_numpy(q).to(dev).to(torch.int8)
    c = (torch.from_numpy((rng.random((1500, d)) > 0.3).astype(np.int8))
         .to(dev) if care else None)
    kernel.reset_launches()
    packed = kernel.pack(q8, t8, levels=m, care=c)
    assert torch.equal(packed[0], ref.pack_planes(q8, m))
    assert torch.equal(packed[1], ref.pack_planes(t8, m))
    assert (packed[2] is None if c is None
            else torch.equal(packed[2], ref.pack_care(c, m)))
    assert torch.equal(kernel.cam_search(q8, t8, levels=m, care=c),
                       ref.mismatch_counts(q8, t8, c, levels=m))
    vr = torch.tensor([1400], dtype=torch.int32, device=dev)
    thr = torch.full((20, 1), float(d // 2), device=dev)
    got = kernel.cam_search_topk(q8, t8, vr, levels=m, k=10, care=c,
                                 count_le=thr)
    want = ref.topk(q8, t8, 10, valid_rows=1400, care=c, count_le=thr,
                    levels=m)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernel.launches == {"cam_search": 1, "cam_search_topk": 1,
                               "cam_search_topk_few": 0, "cam_pack": 3,
                               "cam_pack_l1": 0}


def _unaligned(x):
    """``x`` as int8 in a buffer one byte past an aligned address."""
    buf = torch.empty(x.numel() + 1, dtype=torch.int8, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("d", [1, 5, 16, 37, 4096])
@pytest.mark.parametrize("care", [False, True])
def test_pack_l1_against_the_expansion_chain(dev, bits, d, care):
    """The L1 pack kernel's words and care words against what the L1 path
    packed before it, bit for bit: ``am.thermometer``, ``ops``' int8 cast
    and zero padding, then ``cam_pack`` at levels 2 on the card; and
    against the plain ``ref.pack_planes_l1``.  Codes over all of int8 (out
    of range saturates), odd Q and N, codes at an odd address."""
    rng = np.random.default_rng(bits * 10_000 + d)
    q = torch.from_numpy(rng.integers(-128, 128, (3, d))).to(dev)
    t = torch.from_numpy(rng.integers(-128, 128, (5, d))).to(dev)
    t[1:3] = torch.from_numpy(rng.integers(0, 1 << bits, (2, d))).to(dev)
    c = (torch.from_numpy((rng.random((5, d)) > 0.4).astype(np.int32))
         .to(dev) if care else None)
    kernel.reset_launches()
    q8, t8 = q.to(torch.int8), _unaligned(t)
    c8 = None if c is None else _unaligned(c)
    qp, tp, cp = kernel.pack_l1(q8, t8, bits=bits, care=c8)
    assert kernel.launches["cam_pack_l1"] == 1
    wide = [ops._int8(am.thermometer(x, bits), True) for x in (q, t)]
    wc = (None if c is None else ops._int8(
        torch.repeat_interleave(c, (1 << bits) - 1, dim=-1), True))
    want = kernel.pack(wide[0], wide[1], levels=2, care=wc)
    assert kernel.launches == {"cam_search": 0, "cam_search_topk": 0,
                               "cam_search_topk_few": 0, "cam_pack": 1,
                               "cam_pack_l1": 1}
    assert torch.equal(qp, want[0]) and torch.equal(tp, want[1])
    assert torch.equal(qp, ref.pack_planes_l1(q8, bits))
    assert torch.equal(tp, ref.pack_planes_l1(t8, bits))
    if care:
        assert torch.equal(cp, want[2])
        assert torch.equal(cp, ref.pack_care_l1(c8, bits))
    else:
        assert cp is None


@pytest.mark.parametrize("bits,n,d", [(3, 3001, 64), (2, 700, 37),
                                      (4, 129, 333), (7, 300, 9)])
@pytest.mark.parametrize("masked", [False, True])
def test_l1_search_on_the_card_matches_ref(dev, bits, n, d, masked):
    """``am.search`` (fused tier, and the dense one past k = 256, with and
    without a threshold count) and ``am.distances`` on L1 tables on the
    card against the ``ref`` backend: the same rows and distances.  Each
    search is one ``cam_pack_l1`` launch and no ``cam_pack``; a Hamming
    search launches no ``cam_pack_l1``."""
    rng = np.random.default_rng(bits + n + d)
    codes = rng.integers(0, 1 << bits, (n, d)).astype(np.int32)
    codes[7::11] = codes[2]                           # ties
    queries = np.concatenate([codes[rng.integers(0, n, 21)],
                              rng.integers(0, 1 << bits, (12, d))])
    care = (rng.random((n, d)) > 0.25).astype(np.int32) if masked else None
    gpu = am.make_table(codes, bits=bits, distance="l1", care_mask=care)
    cpu = am.make_table(codes, bits=bits, distance="l1", care_mask=care,
                        device="cpu")
    calls = [dict(k=1), dict(k=10, valid_rows=n - 5), dict(k=300),
             dict(matches=6, threshold=float(d // 2))]
    for kw in calls:
        kernel.reset_launches()
        a = am.search(gpu, queries, backend="cuda", **kw)
        tier = "cam_search" if min(kw.get("k", 1), n) > am.FUSED_K_MAX \
            else "cam_search_topk"
        want = {"cam_search": 0, "cam_search_topk": 0,
                "cam_search_topk_few": 0, "cam_pack": 0, "cam_pack_l1": 1}
        want[tier] = 1
        assert kernel.launches == want, (kw, kernel.launches)
        b = am.search(cpu, queries, backend="ref", **kw)
        for f in dataclasses.fields(b):
            assert torch.equal(getattr(a, f.name).cpu(),
                               getattr(b, f.name)), (kw, f.name)
    kernel.reset_launches()
    dist = am.distances(gpu, queries, backend="cuda")
    assert kernel.launches["cam_pack_l1"] == 1
    assert torch.equal(dist.cpu(), am.distances(cpu, queries, backend="ref"))
    hamming = am.make_table(codes, bits=bits, care_mask=care)
    kernel.reset_launches()
    am.search(hamming, queries, k=3, backend="cuda")
    assert kernel.launches["cam_pack_l1"] == 0
    assert kernel.launches["cam_pack"] == 1


@pytest.mark.parametrize("bits", [2, 3, 7])
def test_l1_codes_past_their_levels_on_the_card(dev, bits):
    """L1 codes outside ``[0, 2^bits)``: within int8 (-128, -1, and below
    7 bits 2^bits and 127) the card clamps them as the ``ref`` backend's
    thermometer does, in the fused and the dense tier; outside int8 (200,
    256, -200; at 7 bits 2^bits = 128 too) they wrap in the int8 cast, as
    every symbol on the card does, so the card answers as the ``ref``
    backend does for their int8 values."""
    rng = np.random.default_rng(bits)
    n, d = 500, 40
    odd = np.array([-128, -1] + ([1 << bits, 127] if bits < 7 else []))
    codes = rng.integers(0, 1 << bits, (n, d))
    mask = rng.random((n, d)) < 0.2
    codes[mask] = rng.choice(odd, int(mask.sum()))
    queries = codes[rng.integers(0, n, 17)].copy()
    qmask = rng.random(queries.shape) < 0.3
    queries[qmask] = rng.choice(odd, int(qmask.sum()))
    gpu = am.make_table(codes, bits=bits, distance="l1")
    cpu = am.make_table(codes, bits=bits, distance="l1", device="cpu")
    for kw in (dict(k=5), dict(k=300)):
        a = am.search(gpu, queries, backend="cuda", **kw)
        b = am.search(cpu, queries, backend="ref", **kw)
        assert torch.equal(a.indices.cpu(), b.indices), kw
        assert torch.equal(a.distances.cpu(), b.distances), kw
    wide = queries.copy()
    wide[:, :3] = [200, 256, -200]
    wrapped = torch.from_numpy(wide).to(torch.int8).to(torch.int32)
    assert wrapped[0, :3].tolist() == [-56, 0, 56]
    a = am.distances(gpu, wide, backend="cuda")
    assert torch.equal(a.cpu(), am.distances(cpu, wrapped, backend="ref"))


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


@pytest.mark.parametrize("b,n,d", [
    (6238, 617, 1024), (2048, 75, 333), (3001, 561, 333),
])
def test_hdc_encode_fp32_gate(dev, b, n, d):
    """Odd n (X rows never 16-byte aligned) and D = 333 (P rows unaligned,
    scalar copies and stores), at path scale."""
    rng = np.random.default_rng(b + n + d)
    x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(dev)
    proj = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        dev)
    thr = q.gaussian_thresholds(3, dev)
    enc_kernel.reset_launches()
    got = enc_kernel.hdc_encode(x, proj, thr)
    assert enc_kernel.launches["hdc_encode"] == 1
    diff = (got.long() - enc_ref.encode_quantize(x, proj, thr).long()).abs()
    assert diff.max().item() <= 1
    assert ((diff != 0).double().mean().item()
            <= enc_kernel.ENCODE_FP32_FRACTION)


@pytest.mark.parametrize("s,c", [(256, 32), (512, 8), (1024, 64), (100, 17),
                                 (1 << 16, 64), (2048, 32), (4099, 17),
                                 (777, 33), (300, 67), (513, 132)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hk,dh,causal", [
    (1, 128, 128, 2, 1, 64, True), (2, 256, 256, 4, 2, 64, True),
    (1, 128, 256, 4, 4, 128, False), (2, 384, 128, 6, 2, 32, False),
    (2, 128, 128, 8, 2, 8, True), (1, 7, 7, 8, 2, 8, True),
    (1, 256, 256, 2, 1, 256, True), (1, 100, 100, 4, 2, 40, True),
    (1, 64, 64, 8, 1, 16, True), (2, 100, 100, 16, 2, 40, False),
    (1, 1024, 1024, 8, 1, 128, True), (1, 7, 7, 8, 1, 100, True),
])
def test_flash_attention_against_plain(dev, dtype, b, s, t, h, hk, dh,
                                       causal):
    gen = torch.Generator(device=dev).manual_seed(s + t + dh)
    q, k, v = (torch.randn((b, n, heads, dh), generator=gen,
                           device=dev).to(dtype)
               for n, heads in ((s, h), (t, hk), (t, hk)))
    fl_kernel.reset_launches()
    got = fl_ops.flash_attention_bshd(q, k, v, causal=causal)
    assert fl_kernel.launches["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape

    def heads_first(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], dh)

    want = fl_ref.attention(heads_first(q), heads_first(k), heads_first(v),
                            group=h // hk, causal=causal)
    want = want.reshape(b, h, s, dh).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:     # and each row, as chip_smoke.py does
        g, w = got.float(), want.float()
        rows = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        assert float(rows.max()) <= 2e-2


def test_lm_flash_forward_on_the_card(dev):
    cfg = get_config("yi_6b", smoke=True)
    flash = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, attn_impl="flash"))
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=dev)
    fl_kernel.reset_launches()
    with torch.no_grad():
        got, _ = transformer.forward(model, flash, tokens)
        assert fl_kernel.launches["flash_attention"] == cfg.n_layers
        want, _ = transformer.forward(model, cfg, tokens)
    torch.testing.assert_close(got.float(), want.float(), atol=0.25,
                               rtol=0.05)
    assert torch.equal(got.float().argmax(-1), want.float().argmax(-1))


@pytest.mark.parametrize("k", [10, 300])          # 300: the dense fallback
@pytest.mark.parametrize("distance", ["hamming", "l1"])
def test_ivf_on_the_card_matches_the_cpu(dev, k, distance):
    """The grouped-by-set fine pass on the card: bitwise the CPU's plain
    path, index planes included, with one pack and one search launch per
    distinct non-empty probed set plus the coarse pass's pair."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 8, (5000, 48)).astype(np.int32)
    queries = np.concatenate([codes[rng.integers(0, 5000, 20)],
                              rng.integers(0, 8, (13, 48))]).astype(np.int32)
    gpu = am.make_table(codes, bits=3, distance=distance)
    cpu = am.make_table(codes, bits=3, distance=distance, device="cpu")
    ig = ivf.build(gpu, sets=24, method="hyperplane", seed=1)
    ic = ivf.build(cpu, sets=24, method="hyperplane", seed=1)
    for f in ("centroids", "slabs", "row_ids", "set_sizes", "set_radius"):
        assert torch.equal(getattr(ig, f).cpu(), getattr(ic, f)), f
    ig = ivf.append(ig, codes[:700], start_row=5000)
    ic = ivf.append(ic, codes[:700], start_row=5000)
    assert torch.equal(ig.slabs.cpu(), ic.slabs)
    for probes in (1, 5, 24):
        kernel.reset_launches()
        a = ivf.search(ig, queries, k=k, probes=probes, backend="cuda")
        b = ivf.search(ic, queries, k=k, probes=probes, backend="cuda")
        for f in ("indices", "distances", "recall_proxy", "probed_sets",
                  "candidate_fraction"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
        sizes = ig.set_sizes.cpu().numpy()
        sets = np.unique(a.probed_sets.cpu().numpy())
        fine = int((sizes[sets] > 0).sum())
        tier = "cam_search_topk" if k <= am.FUSED_K_MAX else "cam_search"
        pack = "cam_pack_l1" if distance == "l1" else "cam_pack"
        want = {"cam_search": 1 + (fine if tier == "cam_search" else 0),
                "cam_search_topk": fine if tier == "cam_search_topk" else 0,
                "cam_search_topk_few": 0, "cam_pack": 0, "cam_pack_l1": 0}
        want[pack] = 1 + fine
        assert kernel.launches == want, (kernel.launches, want)


@pytest.mark.parametrize("merge", ["allgather", "tree", "ring"])
@pytest.mark.parametrize("n,k,distance,valid_rows", [
    (4096, 10, "hamming", None),         # 8 banks of 512 rows
    (3001, 10, "l1", 2500),              # 8 does not divide the rows
    (3001, 300, "hamming", None),        # k above 256: the dense tier
    (37, 20, "hamming", 11),             # banks shorter than k
])
def test_sharded_search_on_the_card_matches_the_cpu(dev, merge, n, k,
                                                    distance, valid_rows):
    """Each bank's fused (or dense) launch on the card, merged: bitwise the
    CPU's plain path and the flat search, one pack and one search launch
    per non-empty bank."""
    from repro_torch.dist import LocalMesh
    mesh = LocalMesh((8,), ("model",))
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 8, (n, 40)).astype(np.int32)
    codes[5::7] = codes[3]                            # ties across banks
    queries = np.concatenate([codes[rng.integers(0, n, 9)],
                              rng.integers(0, 8, (7, 40))]).astype(np.int32)
    gpu = am.make_table(codes, bits=3, distance=distance)
    cpu = am.make_table(codes, bits=3, distance=distance, device="cpu")
    kernel.reset_launches()
    a = am.search_sharded(gpu, queries, mesh=mesh, k=k, backend="cuda",
                          valid_rows=valid_rows, merge=merge)
    banks = min(8, -(-n // -(-n // 8)))
    tier = "cam_search_topk" if min(k, -(-n // 8)) <= am.FUSED_K_MAX \
        else "cam_search"
    pack = "cam_pack_l1" if distance == "l1" else "cam_pack"
    want = {"cam_search": 0, "cam_search_topk": 0, "cam_search_topk_few": 0,
            "cam_pack": 0, "cam_pack_l1": 0}
    want[pack] = want[tier] = banks
    if tier == "cam_search_topk" and -(-n // 8) <= kernel.FEW_ROWS_MAX:
        want["cam_search_topk_few"] = banks        # banks of at most 32 rows
    assert kernel.launches == want, (kernel.launches, want)
    b = am.search_sharded(cpu, queries, mesh=mesh, k=k, backend="cuda",
                          valid_rows=valid_rows, merge=merge)
    flat = am.search(cpu, queries, k=k, backend="ref", valid_rows=valid_rows)
    for f in ("indices", "distances", "exact", "matched"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
        assert torch.equal(getattr(a, f).cpu(), getattr(flat, f)), f


def test_lpm_lookup_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(3)
    routes = [tcam.Route(0, 0, 0)] + [
        tcam.Route(int(rng.integers(0, 1 << 32)), int(rng.integers(8, 33)),
                   i + 1) for i in range(3000)]
    gpu = tcam.build_routing_table(routes, width=16, bits=2)
    cpu = tcam.build_routing_table(routes, width=16, bits=2, device="cpu")
    addrs = np.concatenate([[r.value for r in routes[1:200]],
                            rng.integers(0, 1 << 32, 300)])
    for matches in (8, 33):
        kernel.reset_launches()
        ha, ra = tcam.lookup(gpu, addrs, matches=matches, backend="cuda")
        hb, rb = tcam.lookup(cpu, addrs, matches=matches, backend="cuda")
        assert torch.equal(ha.cpu(), hb)
        for f in ("indices", "distances", "match_count", "overflow"):
            assert torch.equal(getattr(ra, f).cpu(), getattr(rb, f)), f
        assert kernel.launches == {"cam_search": 0, "cam_search_topk": 1,
                                   "cam_search_topk_few": 0, "cam_pack": 1,
                                   "cam_pack_l1": 0}
    for a in addrs[:20].tolist():
        assert int(ha[addrs.tolist().index(a)]) == tcam.lpm_oracle(
            routes, a, width=16, bits=2)


def test_serving_driver_on_the_card(dev):
    kernel.reset_launches()
    out = launch_serve.main([])
    assert sorted(out["results"]) == list(range(6))
    assert out["cache"]["hits"] > 0
    assert kernel.launches["cam_search_topk"] >= 1
