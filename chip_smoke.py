#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, on the
hand-written CUDA kernels, and checks them, in five phases; any failure
exits non-zero without the final ``ok`` line:

1. device and build: the card's name and power limit, then ``nvcc`` builds
   every kernel source of ``src/repro_torch/csrc`` for sm_90a, all at once
   (each build's seconds printed);
2. each kernel against its plain PyTorch version on the card: the two
   CAM-search kernels bitwise, over hamming (bits 1 and 3),
   thermometer-expanded L1, care planes, threshold counts, ``valid_rows``
   below k, k in {1, 10, 256} and ragged N and D, and with symbols outside
   ``[0, levels)`` in queries and table at levels 2, 8 and 128 against the
   plain one-hot rule, their pack kernel bitwise against its plain
   version there; ``hdc_encode`` at the
   reference test's shapes and bits 1-3 (under 0.5 % of codes differ, none
   by more than one level; codes unchanged when the rows are scaled by 3.7
   at the property test's sizes); ``mibo_mc`` at three (S, C) shapes with
   rtol 1e-5, atol 1e-12;
3. the service at full size: a 256-wide, 3-bit table of capacity 2^20
   holding 1,000,000 rows, 4,096 lookups at k = 10 through the driver
   (half exact, half with 8 of 256 symbols perturbed), 64 of them checked
   bitwise against the plain top-k; then an L1 table at k = 10 and at
   k = 300 (the dense tier) and a ternary table with ``matches=16``;
4. the HDC application and the device model: ``hdc_isolet`` fits the
   ISOLET stand-in on the card and runs the Fig. 11(a) and (b) cells
   (``predict_cam`` on the CUDA backend equal to the ``ref`` backend), the
   ``analog`` backend, and the ucihar claims of ``tests/test_system.py``;
   ``hdc_encode`` runs ``encode_quantize`` on each Table III stand-in's
   training features, each held to the reference tolerance and to
   ``ENCODE_FP32_FRACTION`` (at most that fraction of codes differ from
   the plain float32 version: a single TF32 product fails it);
   ``fig9_mc`` runs the Fig. 9 Monte-Carlo study at bits 1-3 and checks
   the 3-bit margin;
4b. the dense LM, yi-6b at full width and depth with random weights drawn
   on the card: ``lm_prefill`` runs the forward at B = 1, S = 4,096 with
   ``attn_impl="flash"`` (32 flash launches) and holds its logits against
   the einsum forward on the same weights (finite, argmax equal at 99 % of
   positions or more, relative L2 difference at most 2.5e-2 with each
   position's input-token column zeroed); ``lm_serve`` runs the serving driver
   (``repro_torch.launch.serve.main(["--arch", "yi-6b", "--full"])``: 3
   slots, 6 requests, 8 new tokens, AM cache of 8 rows), which must answer
   all 6 and serve repeats from the cache, and holds the engine's greedy
   token for two prompts against the forward's argmax;
5. each kernel held against its plain version and timed with CUDA events
   at the shapes its paths gave it, beside its bound, its plain version
   and a library call where one computes the same thing; ``hdc_encode``
   also against ``torch.matmul``'s time for the product alone, and
   ``hdc_encode`` and ``mibo_mc`` also as device time (a CUDA graph of
   launches) beside the time per call.

Phase 2 also holds ``flash_attention`` against its plain version at the
shapes of ``tests/test_flash_attention.py`` (float32 at 2e-5, bfloat16 at
3e-2 and each row at a relative L2 error of 2e-2), at dh = 8, at the
prefill shape, and in bfloat16 (the tensor-core kernel) at each padded
head width.  Every path of phases 3 and 4
runs with the launch counts of every kernel set to 0 just before it and
read just after, and must launch its kernels.
It imports nothing of the JAX package.  Needs one CUDA card, ``nvcc`` and
``nvidia-smi``; the build goes to ``build/repro_torch/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20231007

# H100 SXM peaks from the data sheet, dense: HBM3 bytes/s, int8 ops/s and
# float32 FLOP/s on the CUDA cores (no tensor cores).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12       # tensor cores, dense
TF32_OPS_PER_S = 495e12       # tensor cores, dense

WIDTH, BITS = 256, 3
CAPACITY, ROWS, CHUNK = 1 << 20, 1_000_000, 65_536
LOOKUPS, K = 4096, 10

# HDC: the published dimensions of Fig. 11, (D, bits) per cell
HDC_FIG11A = ((1024, 1), (1024, 3))
HDC_FIG11B = ((1024, 1), (2048, 2), (4096, 3))
HDC_RETRAIN = 3
# Fig. 9: a 32-cell word, 2,048 Monte-Carlo samples; timed also at 2^20 x 64
MC_CELLS, N_MC = 32, 2048
MC_BIG = (1 << 20, 64)
# float32 operations per cell of mibo_mc: per FeFET a subtract, a divide,
# a negate, an exp, an add and a divide (sigmoid), a multiply, an add and
# an exp (log-current), and a max, a multiply, an add and a multiply
# (overdrive), 13 each; then the two currents' sum, the compare and the
# masked add
MIBO_OPS_PER_CELL = 2 * 13 + 3
# the LM: yi-6b, prefill at the length of SHAPES["train_4k"]; the flash
# kernel's shape there (B, S, H, HK, dh)
LM_ARCH, LM_SEQ = "yi-6b", 4096
FLASH_PATH_SHAPE = (1, LM_SEQ, 32, 4, 128)
LM_ARGMAX_AGREEMENT = 0.99
# bf16 flash outputs are also held row by row: the L2 norm of a row's
# difference from plain over the plain row's norm.  A row attending to n
# keys has |o| near sqrt(e / n), about 0.03 at n = 4,096, so the
# elementwise 3e-2 of the reference test is as large as a late row's
# values, while this limit scales with them.  Two bf16 ulps at the top of
# a binade (2 x 2^-7), rounded up: a dh = 8 row, where one value can carry
# the norm, reads up to 9.3e-3 on a sound kernel; a kernel that skips one
# 64-key tile for late rows reads at least 3.4e-2 there (PERF.md, PR 13).
FLASH_BF16_ROW_REL = 2e-2
# The flash forward's logits against the einsum forward's, as a relative
# L2 difference with the input token's own column zeroed in both (with
# tied embeddings drawn at std 1 that column dominates every row, and with
# it the argmax).  The sound flash path reads 1.99e-2 (rounding of the
# bf16 residual stream through 32 layers), the skipped-tile kernel above
# 2.96e-2 (PERF.md, PR 13).
LM_LOGIT_REL_L2 = 2.5e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"build: {len(paths)} librar{'y' if len(paths) == 1 else 'ies'} "
          f"in {dt:.1f} s, all nvcc runs at once")
    for name, (secs, log) in _build.build_logs.items():
        print(f"  {name}: built in {secs:.1f} s")
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    return dt


def _kernel_modules():
    from repro_torch.kernels.cam_search import kernel as cam
    from repro_torch.kernels.flash_attention import kernel as fl
    from repro_torch.kernels.hdc_encode import kernel as enc
    from repro_torch.kernels.mibo_mc import kernel as mc
    return cam, enc, mc, fl


def reset_launches():
    """Set the launch count of every kernel to 0."""
    for mod in _kernel_modules():
        mod.reset_launches()


def read_launches():
    """Every kernel's launch count since the last reset, by kernel name."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _thermo(x, bits):
    m = 1 << bits
    return (x[..., None] >= np.arange(1, m)).astype(np.int32).reshape(
        *x.shape[:-1], x.shape[-1] * (m - 1))


def kernel_cases():
    """(name, bits, Q, N, D, care?, count_le?, valid_rows, k, l1?)."""
    return [
        ("b1-ragged", 1, 5, 1000, 37, False, False, None, 1, False),
        ("b1-ties", 1, 8, 513, 16, False, True, None, 256, False),
        ("b3-vr<k", 3, 17, 300, 100, False, False, 5, 10, False),
        ("b3-care-count", 3, 64, 4099, 256, True, True, 4000, 256, False),
        ("b3-q1", 3, 1, 777, 48, True, False, None, 10, False),
        ("l1-care", 3, 33, 2000, 20, True, True, 1500, 10, True),
        ("b3-wide", 3, 64, 131_072, 256, False, False, 120_000, 10, False),
    ]


def phase_kernels():
    import torch
    from repro_torch.kernels.cam_search import ops, ref
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    err = {"cam_search": 0.0, "cam_search_topk": 0.0, "cam_pack": 0.0}
    for name, bits, qn, n, d, has_care, counted, vr, k, l1 in kernel_cases():
        m = 1 << bits
        codes = rng.integers(0, m, (n, d)).astype(np.int32)
        codes[1::7] = codes[0]                  # duplicate rows: ties
        q = rng.integers(0, m, (qn, d)).astype(np.int32)
        q[0] = codes[0]
        care = ((rng.random((n, d)) > 0.25).astype(np.int32)
                if has_care else None)
        if l1:
            if care is not None:
                care = np.repeat(care, m - 1, axis=-1)
            codes, q, bits = _thermo(codes, bits), _thermo(q, bits), 1
        t_q = torch.from_numpy(q).to(dev).to(torch.int8)
        t_t = torch.from_numpy(codes).to(dev).to(torch.int8)
        t_c = None if care is None else torch.from_numpy(care).to(dev)
        thr = None
        if counted:
            thr = torch.from_numpy(
                rng.integers(0, d // 2, (qn, 1)).astype(np.float32)).to(dev)
        # dense tier
        want = ref.mismatch_counts(t_q, t_t, t_c)
        for tile in _tiles(qn):
            with _query_tile(tile):
                got = ops.mismatch_counts(t_q, t_t, bits, care=t_c)
            torch.cuda.synchronize()
            check(got.dtype == torch.int32
                  and got.shape == (qn, codes.shape[0]),
                  f"{name}: dense dtype/shape {got.dtype} {tuple(got.shape)}")
            diff = (got.long() - want.long()).abs().max().item()
            err["cam_search"] = max(err["cam_search"], float(diff))
            check(diff == 0,
                  f"{name}/{tile}: cam_search differs from plain by {diff}")
        # fused tier
        want = ref.topk(t_q, t_t, k, valid_rows=vr, care=t_c, count_le=thr)
        for tile in _tiles(qn):
            with _query_tile(tile):
                got = ops.topk_fused(t_q, t_t, k, bits, valid_rows=vr,
                                     care=t_c, count_le=thr)
            torch.cuda.synchronize()
            for part, g, w in zip(("rows", "distances", "counts"), got, want):
                check(torch.equal(g, w), f"{name}/{tile}: cam_search_topk "
                      f"{part} differ from plain")
        print(f"  {name}: Q={qn} N={codes.shape[0]} D={codes.shape[1]} "
              f"k={k} bitwise equal (query tiles {_tiles(qn)})")
    _check_out_of_range(rng, dev)
    err["hdc_encode"] = _check_hdc_encode(rng, dev)
    err["mibo_mc"] = _check_mibo_mc(rng, dev)
    err["flash_attention"] = _check_flash_attention(dev)
    return err


def out_of_range_cases():
    """(bits, Q, N, D, care?, k, valid_rows): symbols outside [0, 2**bits)
    in queries and table; D = 16 and 48 leave the last 32-symbol group of
    the planes half empty."""
    return [(1, 9, 1000, 48, False, 10, 990),
            (3, 70, 3000, 48, True, 256, 2500),
            (3, 16, 777, 16, False, 1, None),
            (7, 33, 2000, 64, True, 10, 1999)]


def _check_out_of_range(rng, dev):
    """The pack kernel bitwise against its plain version, and both search
    kernels bitwise against the plain one-hot rule (``levels=``), on
    symbols drawn from [-128, 128) for a third of each query and from a
    few values past both ends of [0, levels) elsewhere."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ops, ref
    for bits, qn, n, d, has_care, k, vr in out_of_range_cases():
        m = 1 << bits
        t = rng.integers(-3, min(m, 125) + 3, (n, d))
        t[1::5] = t[0]
        q = rng.integers(-3, min(m, 125) + 3, (qn, d))
        q[:, : d // 3] = rng.integers(-128, 128, (qn, d // 3))
        q[0] = t[0]
        q[1] = rng.integers(0, m, d)
        t8 = torch.from_numpy(t).to(dev).to(torch.int8)
        q8 = torch.from_numpy(q).to(dev).to(torch.int8)
        care = (torch.from_numpy((rng.random((n, d)) > 0.25).astype(np.int8))
                .to(dev) if has_care else None)
        packed = kernel.pack(q8, t8, levels=m, care=care)
        want = (ref.pack_planes(q8, m), ref.pack_planes(t8, m),
                None if care is None else ref.pack_care(care, m))
        for part, g, w in zip(("queries", "table", "care"), packed, want):
            check(g is None and w is None or torch.equal(g, w),
                  f"out-of-range bits={bits}: cam_pack {part} differ from "
                  f"plain")
        thr = torch.full((qn, 1), float(d // 2), device=dev)
        want_d = ref.mismatch_counts(q8, t8, care, levels=m)
        want_k = ref.topk(q8, t8, k, valid_rows=vr, care=care, count_le=thr,
                          levels=m)
        for tile in _tiles(qn):
            with _query_tile(tile):
                got_d = ops.mismatch_counts(q8, t8, bits, care=care)
                got_k = ops.topk_fused(q8, t8, k, bits, valid_rows=vr,
                                       care=care, count_le=thr)
            torch.cuda.synchronize()
            check(torch.equal(got_d, want_d), f"out-of-range bits={bits}/"
                  f"{tile}: cam_search differs from the one-hot rule")
            for part, g, w in zip(("rows", "distances", "counts"), got_k,
                                  want_k):
                check(torch.equal(g, w), f"out-of-range bits={bits}/{tile}: "
                      f"cam_search_topk {part} differ from the one-hot rule")
        print(f"  out-of-range levels={m}: Q={qn} N={n} D={d} k={k} "
              f"care={has_care}: cam_pack, cam_search and cam_search_topk "
              f"bitwise equal to plain (query tiles {_tiles(qn)})")


def _encode_differs(got, want, where, fp32=False):
    """(fraction of codes that differ, largest difference), checked against
    the reference tolerance: under 0.5 %, none by more than one level;
    with ``fp32`` also against ``ENCODE_FP32_FRACTION``, the gate of a
    float32-accurate product."""
    from repro_torch.kernels.hdc_encode import kernel
    diff = (got.long() - want.long()).abs()
    frac = (diff != 0).double().mean().item()
    top = int(diff.max().item())
    check(frac < 5e-3 and top <= 1, f"hdc_encode {where}: {frac:.2e} of "
          f"codes differ from plain, by up to {top}")
    check(not fp32 or frac <= kernel.ENCODE_FP32_FRACTION,
          f"hdc_encode {where}: {frac:.2e} of codes differ from plain, more "
          f"than ENCODE_FP32_FRACTION = {kernel.ENCODE_FP32_FRACTION:.0e}")
    return frac, top


def _check_hdc_encode(rng, dev):
    """hdc_encode against its plain version at the reference test's shapes
    and bits; then the row-scaling invariance at the property test's
    sizes.  Returns the largest code difference."""
    import torch
    from repro_torch.core import quantize as q
    from repro_torch.kernels.hdc_encode import kernel, ref
    top = 0
    for b, n, d in ((1, 4, 16), (5, 30, 100), (8, 128, 512),
                    (130, 617, 1024), (64, 75, 333)):
        x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
        p = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        x, p = x.to(dev), p.to(dev)
        fracs = []
        for bits in (1, 2, 3):
            thr = q.gaussian_thresholds(bits, device=dev)
            got = kernel.hdc_encode(x, p, thr)
            want = ref.encode_quantize(x, p, thr)
            torch.cuda.synchronize()
            frac, diff = _encode_differs(got, want, f"B={b} n={n} D={d} "
                                         f"bits={bits}")
            fracs.append(f"{frac:.2e}")
            top = max(top, diff)
        print(f"  hdc_encode: B={b} n={n} D={d} bits 1-3: fraction of codes "
              f"differing from plain {', '.join(fracs)}")
    for _ in range(20):
        b, n, d = (int(rng.integers(1, 17)), int(rng.integers(2, 65)),
                   int(rng.integers(1, 129)))
        bits = int(rng.integers(1, 4))
        x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
        p = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        x, p = x.to(dev), p.to(dev)
        thr = q.gaussian_thresholds(bits, device=dev)
        got = kernel.hdc_encode(x, p, thr)
        check(torch.equal(got, kernel.hdc_encode(3.7 * x, p, thr)),
              f"hdc_encode codes change when rows scale by 3.7 at B={b} "
              f"n={n} D={d} bits={bits}")
        check(int(got.min()) >= 0 and int(got.max()) < (1 << bits),
              "hdc_encode code out of range")
    print("  hdc_encode: codes unchanged by a 3.7x row scale at 20 property "
          "test shapes")
    return float(top)


def _mibo_inputs(rng, s, c, bits, dev):
    """Noised V_TH planes and gate rows of a random word and query."""
    import torch
    from repro_torch.core import mibo
    m = 1 << bits
    stored = torch.from_numpy(rng.integers(0, m, c)).to(dev)
    query = torch.from_numpy(rng.integers(0, m, c)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    n1, n2 = (0.054 * torch.randn((s, c), generator=gen, device=dev)
              for _ in range(2))
    v1, v2 = mibo.stored_vths(stored, bits)
    g1, g2 = mibo.search_gate_voltages(query, bits)
    return ((v1[None] + n1).contiguous(), (v2[None] + n2).contiguous(),
            g1[None].contiguous(), g2[None].contiguous())


def _mibo_close(got, want, where):
    """Largest absolute difference, checked at rtol 1e-5, atol 1e-12."""
    import torch
    diff = (got - want).abs()
    bad = diff > 1e-12 + 1e-5 * want.abs()
    check(not bool(bad.any()), f"mibo_mc {where}: {int(bad.sum())} samples "
          f"outside rtol 1e-5 / atol 1e-12 of plain "
          f"(max abs diff {diff.max().item():.3e})")
    torch.cuda.synchronize()
    return float(diff.max().item())


def _check_mibo_mc(rng, dev):
    """mibo_mc against its plain version at three (S, C) shapes."""
    from repro_torch.kernels.mibo_mc import kernel, ref
    top = 0.0
    for s, c in ((256, 32), (100, 17), (1024, 64)):
        args = _mibo_inputs(rng, s, c, 3, dev)
        err = _mibo_close(kernel.mibo_mc(*args), ref.ml_currents(*args),
                          f"S={s} C={c}")
        top = max(top, err)
        print(f"  mibo_mc: S={s} C={c} within rtol 1e-5 of plain "
              f"(max abs diff {err:.3e} A)")
    return top


def _flash_inputs(shape, dtype, seed, dev):
    """(B, S, H, dh) q and (B, T, HK, dh) k, v, standard normal."""
    import torch
    b, s, t, h, hk, dh = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((b, n, heads, dh), generator=gen,
                             device=dev).to(dtype)
                 for n, heads in ((s, h), (t, hk), (t, hk)))


def _flash_close(got, want, tol, where):
    """(largest absolute difference, largest per-row relative L2 error),
    checked at rtol = atol = ``tol`` and, for bf16, each row at
    ``FLASH_BF16_ROW_REL``.  Rows are the last axis."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bad = diff > tol + tol * w.abs()
    check(not bool(bad.any()), f"flash_attention {where}: {int(bad.sum())} "
          f"values outside {tol} of plain (max abs diff "
          f"{diff.max().item():.3e})")
    rows = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    worst = float(rows.max())
    if got.dtype == torch.bfloat16:
        n_bad = int((rows > FLASH_BF16_ROW_REL).sum())
        check(n_bad == 0, f"flash_attention {where}: {n_bad} rows with a "
              f"relative L2 error above {FLASH_BF16_ROW_REL} (max {worst:.3e})")
    return float(diff.max()), worst


def _flash_plain_bshd(q, k, v, causal):
    """The plain version on (B, S, H, dh) q and (B, T, HK, dh) k, v."""
    from repro_torch.kernels.flash_attention import ref
    b, s, h, d = q.shape

    def heads_first(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1], d)

    want = ref.attention(heads_first(q), heads_first(k), heads_first(v),
                         group=h // k.shape[2], causal=causal)
    return want.reshape(b, h, s, d).transpose(1, 2)


def _flash_cases():
    """(shape (B, S, T, H, HK, dh), dtype, causal) of phase 2: the reference
    test's shapes (causal where S == T) in float32, its bf16 case, dh = 8
    in both dtypes, the LM's prefill shape in bf16 (case 9, whose inputs
    ``scripts/flash_fault_check.py`` reuses), then bf16 at each padded head
    width of the tensor-core kernel, ragged and grouped by 8."""
    import torch
    b, s, h, hk, dh = FLASH_PATH_SHAPE
    cases = [((1, 128, 128, 2, 1, 64), torch.float32, c) for c in (1, 0)]
    cases += [((2, 256, 256, 4, 2, 64), torch.float32, c) for c in (1, 0)]
    cases += [((1, 128, 256, 4, 4, 128), torch.float32, 0),
              ((2, 384, 128, 6, 2, 32), torch.float32, 0),
              ((1, 128, 128, 2, 1, 64), torch.bfloat16, 1),
              ((2, 128, 128, 8, 2, 8), torch.float32, 1),
              ((2, 128, 128, 8, 2, 8), torch.bfloat16, 1),
              ((b, s, s, h, hk, dh), torch.bfloat16, 1)]
    cases += [((1, 100, 100, 8, 1, 16), torch.bfloat16, 1),
              ((2, 384, 128, 6, 2, 32), torch.bfloat16, 0),
              ((1, 100, 100, 4, 2, 40), torch.bfloat16, 1),
              ((1, 1024, 1024, 16, 2, 128), torch.bfloat16, 1),
              ((1, 256, 256, 2, 1, 256), torch.bfloat16, 1),
              ((1, 7, 7, 8, 1, 100), torch.bfloat16, 1)]
    return cases


def prefill_case():
    """Index of the LM's prefill shape among :func:`_flash_cases`."""
    b, s, h, hk, dh = FLASH_PATH_SHAPE
    return next(i for i, (shape, _, _) in enumerate(_flash_cases())
                if shape == (b, s, s, h, hk, dh))


def _check_flash_attention(dev):
    """flash_attention through its ops wrapper against the plain version at
    each of :func:`_flash_cases`, case i on inputs drawn from SEED + i."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    top = 0.0
    for i, (shape, dtype, causal) in enumerate(_flash_cases()):
        q, k, v = _flash_inputs(shape, dtype, SEED + i, dev)
        got = ops.flash_attention_bshd(q, k, v, causal=bool(causal))
        want = _flash_plain_bshd(q, k, v, bool(causal))
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        err, row = _flash_close(got, want, tol,
                                f"{shape} {dtype} causal={causal}")
        top = max(top, err)
        rows = (f", rows within {FLASH_BF16_ROW_REL}"
                if dtype == torch.bfloat16 else "")
        print(f"  flash_attention: (B, S, T, H, HK, dh)={shape} "
              f"{str(dtype)[6:]} causal={causal}: within {tol} of plain"
              f"{rows} (max abs diff {err:.3e}, max row relative L2 "
              f"{row:.3e})")
        del q, k, v, got, want
    return top


def _tiles(qn):
    """Query tiles a batch of ``qn`` queries takes: 16 or 64, and for a
    small batch also the 64-query tile the wrapper passes over."""
    return (16, 64) if qn <= 16 else (64,)


@contextlib.contextmanager
def _query_tile(tile):
    """Make the kernel wrappers use ``tile``-query blocks (16 or 64)."""
    from repro_torch.kernels.cam_search import kernel
    saved = kernel.SMALL_TILE_MAX_Q
    kernel.SMALL_TILE_MAX_Q = saved if tile == 16 else 0
    try:
        yield
    finally:
        kernel.SMALL_TILE_MAX_Q = saved


# ---------------------------------------------------------------------------
# phase 3: the service at full size
# ---------------------------------------------------------------------------

def _perturb(rng, word, n_sym, levels):
    out = word.copy()
    pos = rng.choice(word.shape[0], n_sym, replace=False)
    out[pos] = (out[pos] + rng.integers(1, levels, n_sym)) % levels
    return out


def _drive(svc, path, table, queries, **kw):
    """One path: submit ``queries`` to ``table`` and wait for them all.

    The launch counts are set to 0 just before the first submit and read
    just after the last lookup resolved, so they are this path's alone; the
    groups it dispatched are read from the table's bucket counts.  Each
    group is one search, which launches the pack kernel and one search
    kernel: the fused one, or the dense one for k above 256.
    """
    from repro_torch.core import am
    check(svc.drain(timeout=600), f"{path}: driver busy before the path")
    before = svc.stats(table)["buckets"]
    reset_launches()
    t0 = time.perf_counter()
    futs = [svc.submit(table, q, **kw) for q in queries]
    check(svc.drain(timeout=600), f"{path}: driver did not drain")
    seconds = time.perf_counter() - t0
    launches = read_launches()
    after = svc.stats(table)["buckets"]
    buckets = {b: n - before.get(b, 0) for b, n in sorted(after.items())
               if n > before.get(b, 0)}
    groups = sum(buckets.values())
    tier = ("cam_search" if kw.get("k", 1) > am.FUSED_K_MAX
            else "cam_search_topk")
    want = {name: groups if name in (tier, "cam_pack") else 0
            for name in launches}
    check(launches == want, f"{path}: launches {launches}, expected {want} "
          f"for {groups} groups")
    print(f"  {path}: {len(queries)} lookups, {groups} groups "
          f"(buckets {buckets}), launches {launches}, {seconds:.3f} s")
    return futs, {"table": table, **kw, "lookups": len(queries),
                  "seconds": seconds, "launches": launches,
                  "buckets": buckets}


def phase_service():
    import torch
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import ref
    from repro_torch.serve import AMService

    rng = np.random.default_rng(SEED + 1)
    svc = AMService(time_fn=time.monotonic)
    svc.create_table("responses", width=WIDTH, bits=BITS, distance="hamming",
                     capacity=CAPACITY, policy="lru", backend="cuda")
    stored = np.empty((ROWS, WIDTH), np.int8)
    t0 = time.perf_counter()
    for s in range(0, ROWS, CHUNK):
        m = min(CHUNK, ROWS - s)
        chunk = rng.integers(0, 1 << BITS, (m, WIDTH), dtype=np.int32)
        stored[s:s + m] = chunk
        svc.append("responses", chunk, values=list(range(s, s + m)))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    print(f"  filled {ROWS} rows in {fill_s:.2f} s")

    l1_codes = rng.integers(0, 1 << BITS, (CHUNK, WIDTH), dtype=np.int32)
    base = rng.integers(0, 1 << BITS, (4096, WIDTH), dtype=np.int32)
    t_codes = np.tile(base, (16, 1))
    copy_no = np.repeat(np.arange(16), 4096)
    t_care = (np.arange(WIDTH)[None, :]
              < (WIDTH - 16 * copy_no)[:, None]).astype(np.int32)
    svc.create_table("l1", width=WIDTH, bits=BITS, distance="l1",
                     capacity=CHUNK, policy="lru", backend="cuda")
    svc.append("l1", l1_codes, values=list(range(CHUNK)))
    svc.create_table("tcam", width=WIDTH, bits=BITS, capacity=CHUNK,
                     policy="lru", backend="cuda", ternary=True)
    svc.append("tcam", t_codes, care=t_care, values=list(range(CHUNK)))

    rows = rng.integers(0, ROWS, LOOKUPS)
    exact = np.arange(LOOKUPS) < LOOKUPS // 2
    queries = [stored[r].astype(np.int32) if e
               else _perturb(rng, stored[r].astype(np.int32), 8, 1 << BITS)
               for r, e in zip(rows, exact)]
    l1_rows = rng.integers(0, CHUNK, 64)
    t_rows = rng.integers(0, 4096, 64)
    t_queries = [base[r] if i % 2 else _perturb(rng, base[r], 8, 1 << BITS)
                 for i, r in enumerate(t_rows)]
    for i in range(1, 64, 2):          # perturb only don't-care tail cells
        t_queries[i] = base[t_rows[i]].copy()
        t_queries[i][-8:] = (t_queries[i][-8:] + 1) % (1 << BITS)
    torch.cuda.synchronize()

    # -- the slice's paths, each with its own launch counts -----------------
    svc.start_driver(max_in_flight=2)
    paths = {}
    futs, paths["responses_k10"] = _drive(svc, "responses_k10", "responses",
                                          queries, k=K)
    main_stats = svc.stats()
    l1_futs, paths["l1_k10"] = _drive(svc, "l1_k10", "l1",
                                      l1_codes[l1_rows], k=K)
    l1_dense, paths["l1_k300"] = _drive(svc, "l1_k300", "l1",
                                        l1_codes[l1_rows[:4]], k=300)
    t_futs, paths["tcam_m16"] = _drive(svc, "tcam_m16", "tcam", t_queries,
                                       matches=16)
    svc.stop_driver()

    resp = [f.result() for f in futs]
    for i, (r, e) in enumerate(zip(rows, exact)):
        check(resp[i].best_row == r,
              f"lookup {i}: best row {resp[i].best_row} != stored row {r}")
        check(resp[i].hit == bool(e), f"lookup {i}: hit={resp[i].hit}")
        check(e or resp[i].distances[0] == 8.0,
              f"lookup {i}: perturbed distance {resp[i].distances[0]}")
    # 64 dispatched lookups, bitwise against the chunked plain top-k
    pick = np.concatenate([np.arange(32), LOOKUPS // 2 + np.arange(32)])
    table = svc._tables["responses"].table
    q_dev = torch.from_numpy(np.stack([queries[i] for i in pick])).cuda()
    p_idx, p_dist = ref.topk(q_dev, table.codes, K, valid_rows=ROWS)
    p_idx, p_dist = p_idx.cpu().numpy(), p_dist.cpu().numpy()
    for j, i in enumerate(pick):
        check(np.array_equal(resp[i].indices, p_idx[j])
              and np.array_equal(resp[i].distances, p_dist[j]),
              f"lookup {i}: service result differs from the plain top-k")
    # L1 table: exact hits, and the dense tier against the ref backend
    for f, r in zip(l1_futs, l1_rows):
        check(f.result().hit and f.result().best_row == r, "l1 exact lookup")
    l1_table = am.make_table(l1_codes, bits=BITS, distance="l1")
    want = am.search(l1_table, l1_codes[l1_rows[:4]], k=300, backend="ref")
    for j, f in enumerate(l1_dense):
        check(np.array_equal(f.result().indices, want.indices[j].cpu().numpy())
              and np.array_equal(f.result().distances,
                                 want.distances[j].cpu().numpy()),
              "l1 k=300 (dense tier) differs from the ref backend")
    # ternary table: exact base words match all 16 copies, tail-perturbed
    # words the 15 copies whose don't-care tail covers the change
    for i in range(1, 64, 2):
        r = t_futs[i].result()
        check(r.match_count == 15 and not r.overflow,
              f"tcam lookup {i}: match_count {r.match_count} != 15")
        check(r.indices[0] == t_rows[i] + 4096,
              f"tcam lookup {i}: priority row {r.indices[0]}")
    exact_t = svc.lookup("tcam", base[7], matches=16)
    check(exact_t.match_count == 16 and exact_t.indices[0] == 7,
          f"tcam exact word: {exact_t.match_count} matches")

    s = main_stats
    main_s = paths["responses_k10"]["seconds"]
    print(f"  service: {LOOKUPS} lookups in {main_s:.3f} s, "
          f"readbacks={s['readbacks']} flushes={s['flushes']} "
          f"dedup_hits={s['dedup_hits']} compilations={s['compilations']} "
          f"fused_fallbacks={svc.stats()['fused_fallbacks']}")
    service = {"lookups": LOOKUPS, "seconds": main_s,
               "lookups_per_s": LOOKUPS / main_s,
               "queue_wait_p50_s": s["queue_wait_p50"],
               "queue_wait_p99_s": s["queue_wait_p99"],
               "groups": s["readbacks"], "fill_s": fill_s}
    return {"svc": svc, "paths": paths, "service": service,
            "queries": queries, "l1_queries": l1_codes[l1_rows[:4]]}


# ---------------------------------------------------------------------------
# phase 4: the HDC application and the device model
# ---------------------------------------------------------------------------

def _run_path(path, fn, expect):
    """Run one path with every launch count zeroed just before and read
    just after.  ``expect`` maps each kernel the path must launch to its
    exact launch count; every other kernel must not launch."""
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    import torch
    torch.cuda.synchronize()         # the path's work is done when timed
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = {name: expect.get(name, 0) for name in launches}
    check(launches == want, f"{path}: launches {launches}, expected {want}")
    print(f"  {path}: launches {launches}, {seconds:.3f} s")
    return out, {"launches": launches, "seconds": seconds}


def _hdc_setup(name, train=None, test=None):
    from repro_torch.data import hdc_data
    spec = hdc_data.TABLE_III[name]
    if train is not None:
        spec = dataclasses.replace(spec, train_size=train, test_size=test)
    return spec, hdc_data.make_dataset(spec)


def _hdc_fit(spec, x_tr, y_tr, dim):
    from repro_torch.core import hdc
    cfg = hdc.HDCConfig(n_features=spec.n_features, n_classes=spec.n_classes,
                        dim=dim, retrain_epochs=HDC_RETRAIN, bits=3)
    return hdc.fit(hdc.make_model(cfg), x_tr, y_tr)


def _with_bits(model, bits):
    return dataclasses.replace(model, config=dataclasses.replace(
        model.config, bits=bits))


def _hdc_isolet(data):
    """Fig. 11(a) and (b) on the ISOLET stand-in at its published size, the
    analog backend, and the ucihar claims of tests/test_system.py."""
    import torch
    from repro_torch.core import hdc
    spec, (x_tr, y_tr, x_te, y_te) = data["isolet"]
    dims = sorted({d for d, _ in HDC_FIG11A + HDC_FIG11B})
    models = {d: _hdc_fit(spec, x_tr, y_tr, d) for d in dims}
    hvs = {d: hdc.encode(m.projection, x_te) for d, m in models.items()}
    acc, cam_calls = {}, 0

    def cam(d, bits, backend="cuda"):
        nonlocal cam_calls
        m = _with_bits(models[d], bits)
        pred = hdc.predict_cam(m, hvs[d], backend=backend)
        if backend == "cuda":
            cam_calls += 1
            ref = hdc.predict_cam(m, hvs[d], backend="ref")
            check(torch.equal(pred, ref), f"isolet D={d} bits={bits}: "
                  "predict_cam on cuda differs from ref")
        return hdc.accuracy(pred, y_te)

    acc["fp_d1024"] = hdc.accuracy(
        hdc.predict_cosine(models[1024].class_hvs, hvs[1024]), y_te)
    for d, bits in HDC_FIG11A:
        acc[f"cos_{bits}b_d{d}"] = hdc.accuracy(hdc.predict_cosine_quantized(
            models[d].class_hvs, hvs[d], bits), y_te)
    for d, bits in sorted(set(HDC_FIG11A + HDC_FIG11B)):
        acc[f"cam_{bits}b_d{d}"] = cam(d, bits)
    acc["analog_3b_d1024"] = cam(1024, 3, backend="analog")

    spec, (x_tr, y_tr, x_te, y_te) = data["ucihar_1500_500"]
    m = _hdc_fit(spec, x_tr, y_tr, 1024)
    hv = hdc.encode(m.projection, x_te)
    uci = {"fp": hdc.accuracy(hdc.predict_cosine(m.class_hvs, hv), y_te),
           "cos_3b": hdc.accuracy(hdc.predict_cosine_quantized(
               m.class_hvs, hv, 3), y_te),
           "cam_3b": hdc.accuracy(hdc.predict_cam(m, hv, backend="cuda"),
                                  y_te),
           "cam_1b": hdc.accuracy(hdc.predict_cam(_with_bits(m, 1), hv,
                                                  backend="cuda"), y_te)}
    cam_calls += 2
    check(uci["fp"] > 0.85, f"ucihar full-precision accuracy {uci['fp']}")
    check(uci["cam_3b"] > uci["cos_3b"] - 0.07,
          f"ucihar 3-bit CAM {uci['cam_3b']} vs cosine {uci['cos_3b']}")
    return {"isolet": acc, "ucihar_1500_500": uci}, cam_calls


def _encode_inputs(data):
    """(dataset, training features on the card, model projection) for each
    Table III stand-in at D = 1,024, and for ISOLET also at 4,096.  The
    projection is ``make_model``'s; fitting leaves it as it is."""
    import torch
    from repro_torch.core import hdc
    out = []
    for name in ("isolet", "ucihar", "pamap"):
        spec, (x_tr, *_) = data[name]
        x_tr = torch.from_numpy(x_tr).cuda()
        for dim in (1024, 4096) if name == "isolet" else (1024,):
            cfg = hdc.HDCConfig(n_features=spec.n_features,
                                n_classes=spec.n_classes, dim=dim, bits=3)
            out.append((name, x_tr, hdc.make_model(cfg).projection))
    return out


def _hdc_encode_path(inputs):
    """encode_quantize on each stand-in's training features."""
    from repro_torch.kernels.hdc_encode import ops
    return [ops.encode_quantize(x, proj, 3) for _, x, proj in inputs]


def _fig9_path():
    """Fig. 9: match against a single adjacent-level mismatch of a 32-cell
    word, N_MC samples each, at bits 1-3.  Returns, per bits, the stored
    word, the mismatching query, the generator state before each of the two
    draws, and the two current vectors."""
    import torch
    from repro_torch.kernels.mibo_mc import ops
    rng = np.random.default_rng(SEED + 9)
    gen = torch.Generator(device="cuda").manual_seed(42)
    out = {}
    for bits in (1, 2, 3):
        stored = torch.from_numpy(rng.integers(0, 1 << bits, MC_CELLS)).cuda()
        worst = stored.clone()
        worst[0] = (worst[0] + 1) % (1 << bits)
        states, currents = [], []
        for query in (stored, worst):
            states.append(gen.get_state())
            currents.append(ops.monte_carlo_ml_currents(
                stored, query, bits, N_MC, generator=gen))
        out[bits] = (stored, worst, states, currents)
    return out


def _fig9_plain(stored, query, bits, state):
    """The plain version of one Fig. 9 draw, on the noise planes replayed
    from the generator state the kernel's draw started from."""
    import torch
    from repro_torch.core import fefet, mibo
    from repro_torch.kernels.mibo_mc import ref
    gen = torch.Generator(device="cuda")
    gen.set_state(state)
    n1, n2 = (fefet.sample_vth_variation(gen, (N_MC, MC_CELLS))
              for _ in range(2))
    v1, v2 = mibo.stored_vths(stored, bits)
    g1, g2 = mibo.search_gate_voltages(query, bits)
    return ref.ml_currents(v1[None] + n1, v2[None] + n2, g1[None],
                           g2[None])[:, 0]


def phase_app():
    import torch
    from repro_torch.core import mibo, quantize as q
    from repro_torch.kernels.hdc_encode import kernel as enc_kernel
    from repro_torch.kernels.hdc_encode import ref as enc_ref
    paths = {}
    # the Table III stand-ins, made on the host before the paths run
    data = {name: _hdc_setup(name) for name in ("isolet", "ucihar", "pamap")}
    data["ucihar_1500_500"] = _hdc_setup("ucihar", 1500, 500)
    n_cam = len(set(HDC_FIG11A + HDC_FIG11B)) + 2      # + the ucihar two
    (accs, cam_calls), paths["hdc_isolet"] = _run_path(
        "hdc_isolet", lambda: _hdc_isolet(data),
        {"cam_search_topk": n_cam, "cam_pack": n_cam})
    check(cam_calls == n_cam, f"hdc_isolet made {cam_calls} CUDA searches")
    print(f"  hdc_isolet accuracies: {json.dumps(accs)}")
    paths["hdc_isolet"]["accuracy"] = accs

    inputs = _encode_inputs(data)
    runs, paths["hdc_encode"] = _run_path(
        "hdc_encode", lambda: _hdc_encode_path(inputs),
        {"hdc_encode": len(inputs)})
    thr = q.gaussian_thresholds(3, device="cuda")
    encode_shapes = []
    for (name, x, proj), codes in zip(inputs, runs):
        frac, _ = _encode_differs(codes, enc_ref.encode_quantize(x, proj, thr),
                                  f"{name} D={proj.shape[1]}", fp32=True)
        print(f"  hdc_encode {name}: B={x.shape[0]} n={x.shape[1]} "
              f"D={proj.shape[1]}: {frac:.2e} of codes differ from plain "
              f"(ENCODE_FP32_FRACTION {enc_kernel.ENCODE_FP32_FRACTION:.0e})")
        encode_shapes.append((x, proj))
    del runs

    mc, paths["fig9_mc"] = _run_path("fig9_mc", _fig9_path, {"mibo_mc": 6})
    sa = mibo.I_D_THRESHOLD * 3          # TIQ sense-amp trip point
    fig9, mc_err = {}, 0.0
    for bits, (stored, worst, states, (i_match, i_mm)) in mc.items():
        for query, state, got in zip((stored, worst), states,
                                     (i_match, i_mm)):
            mc_err = max(mc_err, _mibo_close(
                got, _fig9_plain(stored, query, bits, state),
                f"fig9 bits={bits}"))
        fig9[bits] = {
            "min_mismatch_A": float(i_mm.min()),
            "max_match_A": float(i_match.max()),
            "match_samples_at_or_above_min_mismatch": int(
                (i_match >= i_mm.min()).sum()),
            "p1_mismatch_A": float(torch.quantile(i_mm, 0.01)),
            "p99_match_A": float(torch.quantile(i_match, 0.99)),
            "match_leak_rate": float((i_match > sa).float().mean()),
            "mismatch_miss_rate": float((i_mm < sa).float().mean())}
        print(f"  fig9_mc bits={bits}: {json.dumps(fig9[bits])}")
    print(f"  fig9_mc: kernel within rtol 1e-5 of plain on the replayed "
          f"noise (max abs diff {mc_err:.3e} A)")
    # The margin claim of tests/test_kernels.py::test_mibo_mc_margin_
    # separation that holds for every draw: p1(mismatch) > 3 p99(match).
    # Its other claim, min(mismatch) > max(match), is about the two sample
    # extremes; under the device model's own arithmetic it holds for about
    # two draws in three at 2,048 samples, so it is reported, not gated.
    check(fig9[3]["p1_mismatch_A"] > 3 * fig9[3]["p99_match_A"],
          "fig9_mc: 3-bit p1(mismatch) <= 3 p99(match)")
    paths["fig9_mc"]["fig9"] = fig9
    paths["fig9_mc"]["max_abs_err_vs_plain"] = mc_err
    return paths, encode_shapes


# ---------------------------------------------------------------------------
# phase 4b: the dense LM at full width
# ---------------------------------------------------------------------------

def _lm_setup():
    """(cfg, its flash variant, weights drawn on the card from SEED, init
    seconds, the (1, LM_SEQ) token batch) of the LM paths."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    cfg = get_config(LM_ARCH)
    flash = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, attn_impl="flash"))
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, (1, LM_SEQ))).cuda()
    return cfg, flash, params, init_s, tokens


def _lm_prefill():
    """yi-6b's forward at B = 1, S = 4,096 on the flash kernel, held against
    the einsum forward on the same weights."""
    import torch
    from repro_torch.models import transformer
    cfg, flash, params, init_s, tokens = _lm_setup()
    n_params = sum(p.numel() for p in params.parameters())
    (logits, aux), path = _run_path(
        "lm_prefill", lambda: transformer.forward(params, flash, tokens),
        {"flash_attention": cfg.n_layers})
    check(logits.shape == (1, LM_SEQ, cfg.vocab_padded),
          f"lm_prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "lm_prefill: non-finite logits")
    t0 = time.perf_counter()
    want, _ = transformer.forward(params, cfg, tokens)
    torch.cuda.synchronize()
    einsum_s = time.perf_counter() - t0
    gate = _lm_readings(logits, want, tokens)
    _lm_gate(gate)
    print(f"  lm_prefill: {cfg.name} {n_params / 1e9:.3f} B params "
          f"(init {init_s:.2f} s), logits (1, {LM_SEQ}, {cfg.vocab_padded}) "
          f"finite; against einsum: argmax agreement "
          f"{gate['argmax_agreement']:.4f} (argmax = input token at "
          f"{gate['argmax_is_input_token']:.4f}), relative L2 without the "
          f"input token's column {gate['logit_rel_l2']:.3e} (limit "
          f"{LM_LOGIT_REL_L2}), max |logit diff| "
          f"{gate['max_abs_logit_diff']:.4f} (largest |logit| "
          f"{gate['max_abs_logit']:.2f}); einsum forward {einsum_s:.3f} s")
    path.update({"arch": cfg.name, "params": n_params, "seq": LM_SEQ,
                 "init_s": init_s, **gate, "einsum_forward_s": einsum_s})
    return path


def _lm_readings(got, want, tokens):
    """The flash forward's logits against the einsum forward's on the same
    weights: argmax agreement, the share of positions whose argmax is the
    input token, the largest difference, and the relative L2 difference
    with each position's input-token column zeroed in both."""
    g, w = got.float(), want.float()
    out = {"argmax_agreement": float(
               (g.argmax(-1) == w.argmax(-1)).double().mean()),
           "argmax_is_input_token": float(
               (w.argmax(-1) == tokens).double().mean()),
           "max_abs_logit_diff": float((g - w).abs().max()),
           "max_abs_logit": float(w.abs().max())}
    g.scatter_(-1, tokens[..., None], 0.0)
    w.scatter_(-1, tokens[..., None], 0.0)
    out["logit_rel_l2"] = float((g - w).norm() / w.norm())
    return out


def _lm_gate(r):
    """Argmax agreement at ``LM_ARGMAX_AGREEMENT`` or more and the relative
    L2 difference at ``LM_LOGIT_REL_L2`` or less."""
    check(r["argmax_agreement"] >= LM_ARGMAX_AGREEMENT, f"lm_prefill: argmax "
          f"agrees with the einsum forward at {r['argmax_agreement']:.4f} of "
          f"positions")
    check(r["logit_rel_l2"] <= LM_LOGIT_REL_L2, f"lm_prefill: logits differ "
          f"from the einsum forward's by a relative L2 of "
          f"{r['logit_rel_l2']:.3e} without the input token's column")


def _engine_against_forward(out, n=2):
    """For the first ``n`` distinct prompts of the served workload: a fresh
    one-slot engine's greedy next token against the forward's argmax at the
    last position.  The logits are held at the reference's decode-vs-forward
    tolerance (atol 0.55, rtol 0.05); the tokens must be equal unless the
    forward's top-2 margin is within twice the largest logit difference,
    where bf16 rounding may flip a near-tie."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine
    eng0 = out["engine"]
    cfg, params = eng0.cfg, eng0.params
    prompts = []
    for p in out["workload"]:
        if not any(np.array_equal(p, q) for q in prompts):
            prompts.append(p)
    checks = []
    for p in prompts[:n]:
        eng = Engine.create(cfg, params, batch=1, max_len=32)
        t0 = time.perf_counter()
        got = eng.prefill(p[None])[0]            # ends in a copy to the host
        step_ms = (time.perf_counter() - t0) * 1e3 / len(p)
        want, _ = transformer.forward(params, cfg, torch.from_numpy(p[None])
                                      .cuda())
        want = want[0, -1, :cfg.vocab_size].float().cpu()
        diff = (got - want).abs()
        check(bool((diff <= 0.55 + 0.05 * want.abs()).all()),
              f"lm_serve: engine logits differ from forward by up to "
              f"{float(diff.max()):.3f}")
        top2 = want.topk(2).values
        margin, delta = float(top2[0] - top2[1]), float(diff.max())
        same = int(got.argmax()) == int(want.argmax())
        check(same or margin <= 2 * delta, f"lm_serve: greedy token "
              f"{int(got.argmax())} != forward argmax {int(want.argmax())} "
              f"at top-2 margin {margin:.3f} > 2 x {delta:.3f}")
        checks.append({"prompt_len": len(p), "engine_token": int(got.argmax()),
                       "forward_token": int(want.argmax()), "equal": same,
                       "top2_margin": margin, "max_abs_logit_diff": delta,
                       "engine_ms_per_step": step_ms})
    return checks


def _lm_serve():
    """The serving driver at full width, launch counts read around it."""
    import torch
    from repro_torch.launch import serve as launch_serve
    reset_launches()
    t0 = time.perf_counter()
    out = launch_serve.main(["--arch", LM_ARCH, "--full"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    cache = out["cache"]
    groups = sum(cache["buckets"].values())
    want = {name: groups if name in ("cam_search_topk", "cam_pack") else 0
            for name in launches}
    check(launches == want, f"lm_serve: launches {launches}, expected "
          f"{want} for {groups} lookup groups")
    check(sorted(out["results"]) == list(range(6)),
          f"lm_serve answered {sorted(out['results'])}")
    check(cache["hits"] > 0, "lm_serve: no repeat was served from the cache")
    checks = _engine_against_forward(out)
    print(f"  lm_serve: launches {launches}, {seconds:.3f} s; 6/6 answered, "
          f"{len(out['generated'])} generated in {out['ticks']} ticks, cache "
          f"{cache['hits']}/{cache['lookups']} hits; engine vs forward "
          f"{json.dumps(checks)}")
    return {"launches": launches, "seconds": seconds, "groups": groups,
            "answered": len(out["results"]), "generated": len(out["generated"]),
            "ticks": out["ticks"], "hits": cache["hits"],
            "lookups": cache["lookups"], "engine_vs_forward": checks}


def phase_lm():
    import torch
    paths = {"lm_prefill": _lm_prefill()}
    torch.cuda.empty_cache()
    paths["lm_serve"] = _lm_serve()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

def _time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _graph_ms(fn, reps, warmup=2):
    """Mean ms of ``reps`` calls captured in one CUDA graph and replayed
    between one pair of events: the device's time, without the host's
    work per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def _timed_once(fn):
    """(ms, result) of one call, timed with CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def _bound_parts(bytes_moved, ops):
    """(ms at the memory rate, ms at the int8 operation rate)."""
    return bytes_moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


def _time_dense(q8, t8, levels, groups, err):
    """One shape of the dense kernel: held against plain, then timed
    through its wrapper (the pack launch included), with
    ``torch.cdist(p=0)`` on float copies as the library call."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    plain_ms, want = _timed_once(lambda: ref.mismatch_counts(q8, t8))
    got = kernel.cam_search(q8, t8, levels=levels)
    diff = float((got.long() - want.long()).abs().max().item())
    err["cam_search"] = max(err["cam_search"], diff)
    check(diff == 0, f"cam_search differs from plain by {diff} at "
          f"Q={qn} N={n} D={d}")
    del got, want
    ms = _time_ms(lambda: kernel.cam_search(q8, t8, levels=levels), 10)
    qf, tf = q8.float(), t8.float()
    lib_ms = _time_ms(lambda: torch.cdist(qf, tf, p=0), 5, 1)
    del qf, tf
    t_b, t_o = _bound_parts(qn * d + n * d + qn * n * 4, qn * n * d)
    return {"Q": qn, "N": n, "D": d, "groups": groups, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bytes_ms": t_b, "ops_ms": t_o}


def _time_fused(q8, t8, vr, levels, k, groups, err):
    """One shape of the fused kernel: held against plain, then timed
    through its wrapper (the pack launch included).  Its bound counts the
    live rows only, the ones the result depends on."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    plain_ms, want = _timed_once(lambda: ref.topk(q8, t8, k, valid_rows=vr))
    got = kernel.cam_search_topk(q8, t8, vr, levels=levels, k=k)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"cam_search_topk differs from plain at Q={qn} N={n} D={d} k={k}")
    del got, want
    ms = _time_ms(lambda: kernel.cam_search_topk(q8, t8, vr, levels=levels,
                                                 k=k), 10)
    live = int(vr.item())
    t_b, t_o = _bound_parts(qn * d + live * d + 4 + qn * k * 8,
                            qn * live * d)
    return {"Q": qn, "N": n, "D": d, "k": k, "groups": groups, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bytes_ms": t_b, "ops_ms": t_o}


def _time_pack(q8, t8, levels, groups):
    """One shape of the pack kernel: held against plain, then timed.  Its
    bound is the bytes it must move: the int8 inputs read once, the plane
    words written once."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    plain_ms, want = _timed_once(lambda: (ref.pack_planes(q8, levels),
                                          ref.pack_planes(t8, levels)))
    got = kernel.pack(q8, t8, levels=levels)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"cam_pack differs from plain at Q={qn} N={n} D={d}")
    del got, want
    ms = _time_ms(lambda: kernel.pack(q8, t8, levels=levels), 10)
    _, words, gp = ref.plane_layout(d, levels)
    t_b, t_o = _bound_parts((qn + n) * (d + gp * words * 4),
                            (qn + n) * d)
    return {"Q": qn, "N": n, "D": d, "groups": groups, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bytes_ms": t_b, "ops_ms": t_o}


def _tile_ms(fn):
    """The kernel call ``fn`` timed with 16- and with 64-query blocks."""
    out = {}
    for tile in (16, 64):
        with _query_tile(tile):
            out[f"ms_tile{tile}"] = _time_ms(fn, 10)
    return out


def _row(name, replaces, path, paths, shapes, err,
         source="src/repro_torch/csrc/cam_search.cu", keys=()):
    """One kernel's line.  ``ms``, ``plain_ms``, ``bound_ms``,
    ``library_ms`` and each of ``keys`` are means over the groups that
    ``path`` dispatched, each group's shape timed alone; ``launches`` sums
    the counts of every path, and ``launches_by_path`` gives each."""
    main = [s for s in shapes if s["groups"]]
    g = sum(s["groups"] for s in main)

    def mean(key):
        return sum(s[key] * s["groups"] for s in main) / g

    t_b, t_o = mean("bytes_ms"), mean("ops_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "max_abs_err": err[name], "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": (None if main[0]["library_ms"] is None
                           else mean("library_ms")),
            "timed_path": path,
            "launches_by_path": {p: v["launches"][name]
                                 for p, v in paths.items()},
            **{k: mean(k) for k in keys}, "shapes": shapes}


def phase_timing(run, err):
    import torch
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import kernel
    svc, paths = run["svc"], run["paths"]
    levels = 1 << BITS
    codes = svc._tables["responses"].table.codes          # (2^20, 256) int32
    t8 = codes.to(torch.int8)
    dev = t8.device
    vr = torch.full((1,), ROWS, dtype=torch.int32, device=dev)
    cast_ms = _time_ms(lambda: codes.to(torch.int8), 10)
    order = np.random.default_rng(SEED + 2).permutation(LOOKUPS)
    q_all = torch.from_numpy(np.stack(run["queries"])[order]).to(dev)

    def batch(qn):
        return q_all[:qn].to(torch.int8).contiguous()

    # fused kernel: each bucket size the main path dispatched, then Q = 64
    # and the small batches, these also with 64-query blocks
    buckets = paths["responses_k10"]["buckets"]
    fused = [_time_fused(batch(qb), t8, vr, levels, K, n, err)
             for qb, n in buckets.items()]
    if 64 not in buckets:
        fused.append(_time_fused(batch(64), t8, vr, levels, K, 0, err))
    for qn in (1, 4, 16):
        q8 = batch(qn)
        shape = _time_fused(q8, t8, vr, levels, K, 0, err)
        shape.update(_tile_ms(lambda: kernel.cam_search_topk(
            q8, t8, vr, levels=levels, k=K)))
        fused.append(shape)

    # pack kernel, at each bucket size the main path dispatched
    packs = [_time_pack(batch(qb), t8, levels, n)
             for qb, n in buckets.items()]

    # dense kernel: the L1 k = 300 path's thermometer-expanded table (its
    # queries padded to the bucket as the service pads them), then the
    # responses table at Q = 64
    l1_codes = svc._tables["l1"].table.codes                # (65536, 256)
    l1_expand_ms = _time_ms(
        lambda: am.thermometer(l1_codes, BITS).to(torch.int8), 5)
    l1_t8 = am.thermometer(l1_codes, BITS).to(torch.int8)
    l1_q = am.thermometer(torch.from_numpy(run["l1_queries"]).to(dev),
                          BITS).to(torch.int8)
    dense = []
    for qb, n in paths["l1_k300"]["buckets"].items():
        q8 = torch.zeros((qb, l1_q.shape[1]), dtype=torch.int8, device=dev)
        q8[:min(qb, l1_q.shape[0])] = l1_q[:qb]
        shape = _time_dense(q8, l1_t8, 2, n, err)
        if qb <= 16:
            shape.update(_tile_ms(lambda: kernel.cam_search(
                q8, l1_t8, levels=2)))
        dense.append(shape)
    del l1_t8
    dense.append(_time_dense(batch(64), t8, levels, 0, err))

    rows = [
        _row("cam_search", "src/repro/kernels/cam_search/kernel.py:114",
             "l1_k300", paths, dense, err),
        _row("cam_search_topk", "src/repro/kernels/cam_search/kernel.py:402",
             "responses_k10", paths, fused, err),
        _row("cam_pack", "src/repro/kernels/cam_search/kernel.py:59",
             "responses_k10", paths, packs, err),
    ]
    for r in rows:
        for s in r["shapes"]:
            tiles = "".join(f" {key}={s[key]:.4f}" for key in s
                            if key.startswith("ms_tile"))
            print(f"  {r['name']}: Q={s['Q']} N={s['N']} D={s['D']} "
                  f"groups={s['groups']} ms={s['ms']:.4f} "
                  f"plain_ms={s['plain_ms']:.2f}{tiles}")
    kernel_ms = sum(s["ms"] * s["groups"] for s in fused)
    print(f"  int32->int8 table cast {cast_ms:.4f} ms per call; L1 "
          f"thermometer expansion + cast {l1_expand_ms:.4f} ms per search; "
          f"fused kernel time of the main path {kernel_ms:.2f} ms")
    return rows, {"table_cast_ms": cast_ms, "l1_expand_ms": l1_expand_ms,
                  "main_path_kernel_ms": kernel_ms}


def _fp32_bound(bytes_moved, ops):
    """(ms at the memory rate, ms at the float32 CUDA-core rate)."""
    return bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


def _time_encode(x, proj, groups, err):
    """One shape of hdc_encode: held against plain (reference tolerance and
    ``ENCODE_FP32_FRACTION``), then timed beside the plain version and
    torch.matmul's time for the product alone.  ``ms`` and
    ``matmul_product_only_ms`` are medians of calls timed one at a time
    (the host's work per call included), ``device_ms`` and
    ``matmul_device_ms`` device time per launch (20 launches in one CUDA
    graph).  The bound is the tensor cores' route, three TF32 products at
    495 TFLOP/s, against the bytes; ``fp32_cuda_core_bound_ms`` is the
    same work in float32 on the CUDA cores."""
    from repro_torch.core import quantize as q
    from repro_torch.kernels.hdc_encode import kernel, ref
    (b, n), d = x.shape, proj.shape[1]
    thr = q.gaussian_thresholds(3, device=x.device)
    plain_ms, want = _timed_once(lambda: ref.encode_quantize(x, proj, thr))
    frac, top = _encode_differs(kernel.hdc_encode(x, proj, thr), want,
                                f"timed B={b} n={n} D={d}", fp32=True)
    err["hdc_encode"] = max(err["hdc_encode"], float(top))
    del want
    ms = _time_ms(lambda: kernel.hdc_encode(x, proj, thr), 10)
    device_ms = _graph_ms(lambda: kernel.hdc_encode(x, proj, thr), 20)
    plain_ms = min(plain_ms, _time_ms(
        lambda: ref.encode_quantize(x, proj, thr), 3, 1))
    matmul_ms = _time_ms(lambda: x @ proj, 10)
    matmul_device_ms = _graph_ms(lambda: x @ proj, 20)
    t = thr.numel()
    bytes_moved = 4 * (b * n + n * d + t + b * d)
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = 3 * 2 * b * n * d / TF32_OPS_PER_S * 1e3
    fp32_b, fp32_o = _fp32_bound(bytes_moved,
                                 2 * b * n * d + 2 * b * n + 2 * b * d * t)
    return {"B": b, "n": n, "D": d, "bits": 3, "groups": groups, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "matmul_product_only_ms": matmul_ms,
            "matmul_device_ms": matmul_device_ms,
            "frac_codes_differ": frac, "bytes_ms": t_b, "ops_ms": t_o,
            "fp32_cuda_core_bound_ms": max(fp32_b, fp32_o)}


def _time_mibo(s, c, groups, err):
    """One (S, C) shape of mibo_mc: held against plain, then timed.  ``ms``
    is the median of calls timed one at a time (the wrapper's host work
    included), ``device_ms`` the device's time per launch (20 launches in
    one CUDA graph)."""
    import torch
    from repro_torch.kernels.mibo_mc import kernel, ref
    args = _mibo_inputs(np.random.default_rng(SEED + s + c), s, c, 3,
                        torch.device("cuda"))
    plain_ms, want = _timed_once(lambda: ref.ml_currents(*args))
    diff = _mibo_close(kernel.mibo_mc(*args), want, f"timed S={s} C={c}")
    err["mibo_mc"] = max(err["mibo_mc"], diff)
    del want
    ms = _time_ms(lambda: kernel.mibo_mc(*args), 10)
    device_ms = _graph_ms(lambda: kernel.mibo_mc(*args), 20)
    plain_ms = min(plain_ms, _time_ms(lambda: ref.ml_currents(*args), 3, 1))
    t_b, t_o = _fp32_bound(4 * (2 * s * c + 2 * c + s),
                           MIBO_OPS_PER_CELL * s * c)
    return {"S": s, "C": c, "groups": groups, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "bytes_ms": t_b, "ops_ms": t_o}


def phase_timing_app(paths, encode_shapes, err):
    """hdc_encode at each shape of its path, mibo_mc at the Fig. 9 shape
    (all six launches of its path) and at 2^20 x 64."""
    enc = [_time_encode(x, p, 1, err) for x, p in encode_shapes]
    mc = [_time_mibo(N_MC, MC_CELLS, 6, err), _time_mibo(*MC_BIG, 0, err)]
    rows = [
        _row("hdc_encode", "src/repro/kernels/hdc_encode/kernel.py:56",
             "hdc_encode", paths, enc, err,
             source="src/repro_torch/csrc/hdc_encode.cu",
             keys=("device_ms", "matmul_product_only_ms",
                   "matmul_device_ms", "fp32_cuda_core_bound_ms")),
        _row("mibo_mc", "src/repro/kernels/mibo_mc/kernel.py:49",
             "fig9_mc", paths, mc, err,
             source="src/repro_torch/csrc/mibo_mc.cu", keys=("device_ms",)),
    ]
    for r in rows:
        for x in r["shapes"]:
            dims = " ".join(f"{k}={x[k]}" for k in ("B", "n", "D", "S", "C")
                            if k in x)
            extra = "".join(
                f" {k}={x[k]:.4f}" for k in (
                    "device_ms", "matmul_product_only_ms",
                    "matmul_device_ms", "fp32_cuda_core_bound_ms") if k in x)
            if "frac_codes_differ" in x:
                extra += f" frac_codes_differ={x['frac_codes_differ']:.3e}"
            bound = max(x["bytes_ms"], x["ops_ms"])
            by = "bytes" if x["bytes_ms"] >= x["ops_ms"] else "operations"
            print(f"  {r['name']}: {dims} launches={x['groups']} "
                  f"ms={x['ms']:.4f} bound_ms={bound:.4f} ({by}) "
                  f"plain_ms={x['plain_ms']:.4f}{extra}")
    return rows


def _time_flash(launches, err):
    """flash_attention at the prefill shape, which ``lm_prefill`` launched
    it at ``launches`` times: held against plain, timed beside the plain
    version and SDPA (``is_causal``, ``enable_gqa``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref
    b, s, h, hk, dh = FLASH_PATH_SHAPE
    q, k, v = (x.transpose(1, 2).reshape(-1, s, dh).contiguous()
               for x in _flash_inputs((b, s, s, h, hk, dh), torch.bfloat16,
                                      SEED + 99, "cuda"))
    plain_ms, want = _timed_once(lambda: ref.attention(q, k, v,
                                                       group=h // hk))
    diff, _ = _flash_close(kernel.flash_attention(q, k, v, group=h // hk),
                           want, 3e-2, "timed prefill shape")
    err["flash_attention"] = max(err["flash_attention"], diff)
    del want
    ms = _time_ms(lambda: kernel.flash_attention(q, k, v, group=h // hk), 10)
    plain_ms = min(plain_ms, _time_ms(
        lambda: ref.attention(q, k, v, group=h // hk), 3, 1))
    q4, k4, v4 = (x.view(b, -1, s, dh) for x in (q, k, v))
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 10)
    t_b = 2 * (2 * b * h * s * dh + 2 * b * hk * s * dh) / HBM_BYTES_PER_S
    t_o = 2 * b * h * s * s * dh / BF16_OPS_PER_S
    return {"B": b, "S": s, "H": h, "HK": hk, "dh": dh, "dtype": "bfloat16",
            "causal": True, "groups": launches, "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes_ms": t_b * 1e3, "ops_ms": t_o * 1e3}


def phase_timing_lm(paths, err):
    shape = _time_flash(paths["lm_prefill"]["launches"]["flash_attention"],
                        err)
    row = _row("flash_attention",
               "src/repro/kernels/flash_attention/kernel.py:76",
               "lm_prefill", paths, [shape], err,
               source="src/repro_torch/csrc/flash_attention.cu")
    print(f"  flash_attention: B=1 S={shape['S']} H={shape['H']} "
          f"HK={shape['HK']} dh={shape['dh']} bf16 causal "
          f"launches={row['launches']} ms={shape['ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"plain_ms={shape['plain_ms']:.4f} sdpa_ms={shape['library_ms']:.4f}")
    return [row]


def main() -> int:
    try:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available()"
                  " is False)", file=sys.stderr)
            return 1
        sys.path.insert(0, os.path.join(ROOT, "src"))
        import repro_torch  # noqa: F401  (fail before printing anything)
        print("phase 1: device and build")
        card = phase_device()
        phase_build()
        print("phase 2: kernels against their plain versions")
        err = phase_kernels()
        print("phase 3: the service at full size")
        run = phase_service()
        print("phase 4: the HDC application and the device model")
        app_paths, encode_shapes = phase_app()
        print("phase 4b: the dense LM at full width")
        lm_paths = phase_lm()
        paths = {**run["paths"], **app_paths, **lm_paths}
        print("phase 5: timing")
        rows, costs = phase_timing({**run, "paths": paths}, err)
        rows += phase_timing_app(paths, encode_shapes, err)
        rows += phase_timing_lm(paths, err)
        service = {**run["service"], **costs}
        print(card)
        print(json.dumps({"kernels": rows, "service": service,
                          "paths": paths}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception as e:                       # report, then fail the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
