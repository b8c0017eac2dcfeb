#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, on the
hand-written CUDA kernels, and checks them, in five phases; any failure
exits non-zero without the final ``ok`` line (a quicker call after a
change to a model family: ``phase_device()``, ``phase_build()`` and
``phase_families()`` alone):

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
   bitwise against the plain top-k; the same lookups through a second
   table holding the same rows behind the IVF index tier (``ivf_k10``:
   1,024 hyperplane sets, 8 probes, built once after the fill), whose
   certified slots must equal the flat search's and whose results must
   equal ``ivf.search``'s; then an L1 table at k = 10 and at k = 300 (the
   dense tier) and a ternary table with ``matches=16``;
3b. TCAM routing and the exact index: ``lpm_v4`` builds a 131,072-route
   IPv4-style table (prefix lengths 8-32 weighted toward /24, a default
   route) with ``tcam.build_routing_table`` and resolves 4,096 addresses
   in one ``lookup``, held to ``lpm_oracle`` on a sample, to the
   ``default_hop`` where nothing matched (the table without its default
   route) and to the same hops at ``matches=33``; ``ivf_exact`` builds a
   k-means index of 64 sets over a 65,536-row table on the card and
   searches it at ``probes=64``, bitwise the flat ``am.search``;
3c. multi-bank sharding and the paper's Fig. 12: ``sharded_k10`` fills a
   second service, sharded over a local mesh of 8 banks (slices of the
   card, ``merge="auto"``), with the same 1,000,000 rows and drives the
   same 4,096 lookups at k = 10, each bitwise its ``responses_k10``
   result (8 ``cam_pack`` + 8 ``cam_search_topk`` launches a group); one
   1,024-query group then goes through ``am.search_sharded`` under each
   of ``allgather``, ``tree`` and ``ring``, bitwise ``am.search``, timed
   with the merge alone beside it; ``ivf_exact_sharded`` (in phase 3b)
   searches the exact index's sets banked over 8 banks, bitwise the flat
   search; ``fig12`` runs ``torch_benchmarks.fig12_speedup.run()`` at its
   full shapes (its CSV lines printed) and holds the measured search of
   its first shape bitwise to the plain top-1;
3d. durability at full size: ``durable_k10`` snapshots phase 3's service
   (``responses``, 1,000,000 rows at capacity 2^20 x 256, with ``l1`` and
   ``tcam``) under ``build/``, prints its bytes on disk and its seconds
   (drain + capture under the lock, write + fsync), restores it with no
   mesh and onto ``LocalMesh((8,), ("model",))`` (``durable_k10_mesh8``),
   each time printing the seconds of ``restore()`` and to the first
   resolved lookup, and drives the 4,096 lookups of ``responses_k10``,
   each bitwise its result (1 + 1, then 8 + 8 launches a group), and the
   ``tcam`` table's ``matches=16`` lookup, equal to the one before;
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
   (``repro_torch.launch.serve.main(["--arch", "yi-6b", "--full",
   "--am-snapshot-dir", ...])``: 3 slots, 6 requests, 8 new tokens, AM
   cache of 8 rows), which must answer all 6 and serve repeats from the
   cache, warm-restarts its cache with ``--am-restore`` (the rows come
   back and a stored prompt's key hits), and holds the engine's greedy
   token for two prompts against the forward's argmax;
4c. training, with phase 4b's weights released first; each path prints
   ``torch.cuda.mem_get_info()`` before it and the peak allocation after,
   and launches no hand-written kernel (the reference trains on the
   einsum attention; the flash kernel has no backward): ``train_yi6b``
   trains yi-6b at full width and 16 of its 32 layers (its 5.80 B
   parameters at 16 bytes of training state each exceed the card) for 6
   steps of ``make_train_step`` at B = 2, S = 2,048 on ``lm_synth``
   batches, weights drawn on the card, remat by block; losses finite and
   falling, the weights changed, ``grad_norm`` finite; it prints the
   median step over steps 2-6 split into forward + backward and optimizer
   by CUDA events, tokens/s and the model FLOP/s share of the bf16 dense
   peak (``roofline.model.model_flops``, the recompute not counted);
   ``train_fsdp`` holds the sharded AdamW update bitwise to the unsharded
   one on yi-6b at full width and 4 layers (``LocalMesh((2, 1), ("data",
   "model"))``: master, m, v, bf16 weights and ``grad_norm``), then runs
   ``train_yi6b``'s 6 steps through ``ShardedTrainStep`` with the batch
   split over ``data`` = 2 (step-1 loss within 1e-3 of ``train_yi6b``'s,
   losses falling, weights changed), split into forward + backward, slice
   update and weight gather, and prints full-depth yi-6b's per-rank state
   at fsdp widths 1, 2, 4 and 8 as arithmetic from ``state_specs``;
   ``train_card_vs_cpu`` runs the float32 smoke config's step 3 times on
   the card and on the CPU from the same state and batches (losses within
   rtol 1e-4, parameters within 1e-5); ``train_loop`` runs
   ``repro_torch.launch.train.train`` for 25 steps with a failure injected
   at step 17 (one restart, final step 25, loss falls);
   ``train_compressed`` runs ``make_train_step_compressed`` on two pods of
   the card (yi-6b full width, 4 layers, B = 4, S = 512, 4 steps; the
   codes summed as int8; the first loss within 2 % of the baseline
   step's), split into per-pod gradients, quantize/reduce and optimizer;
   ``pipeline_fwd`` runs ``make_pp_forward`` over 8 full-width blocks in 2
   stages of 4 microbatches of 1 x 1,024 tokens, held to the blocks
   applied in order (relative L2 at most ``LM_LOGIT_REL_L2``);
4d. the other model families at full width and depth, weights drawn on
   the card from the seed, phase 4c's state released first, each path
   printing ``mem_get_info`` before it and the peak allocation after:
   ``moe_mla_prefill`` runs deepseek-v2-lite-16b (27 layers, d 2,048,
   MLA, 64 routed experts top-6 + 2 shared) at B = 1, S = 4,096 through
   EP on ``LocalMesh((1,), ("model",))`` against the dense oracle on the
   same weights: argmax agreement at 99 % or more end to end, and layer
   by layer on the EP forward's own inputs each MoE block within
   ``MOE_LAYER_REL_L2`` of the oracle (the two forwards' routes flip
   apart through the depth, so their logits are printed, not gated);
   ``moe_mla_serve`` runs ``launch.serve.main(["--arch",
   "deepseek-v2-lite-16b", "--full"])``: decode on the absorbed latent
   cache through EP, the AM cache in front (one ``cam_pack`` and one
   ``cam_search_topk`` per lookup group), 6/6 answered, repeats from the
   cache, greedy tokens of two prompts equal to the forward's argmax;
   ``vlm_prefill`` runs pixtral-12b on the flash kernel (40 launches) over
   256 stub patch embeddings + 3,840 tokens against the einsum forward on
   the token positions (the ``lm_prefill`` gates), and each layer's flash
   attention within ``FLASH_LAYER_REL_L2`` of einsum's on the same input;
   ``hybrid_prefill`` runs recurrentgemma-2b at S = 4,096 (the chunked
   local path), times the RG-LRU scan and holds it to the step-by-step
   recurrence (``SCAN_REL_L2``), then decodes 64 tokens through the
   engine against the forward; ``xlstm_train`` runs xlstm-125m's forward
   at B = 4, S = 2,048, 6 train steps at S = 256 (losses finite and
   falling) and 32 decoded tokens against the forward;
   ``family_sweep_granite_moe`` and ``family_sweep_musicgen`` run
   granite-moe-1b-a400m (EP on one bank) and musicgen-medium (256 stub
   audio frames, dh 64) on the flash kernel at S = 1,024 against einsum
   (24 and 48 launches) and decode 4 tokens against the forward.  A
   decode is held by its greedy token and, but for MoE configs, by the
   relative L2 of its logits (``LM_LOGIT_REL_L2``);
4e. the top-k sweep: ``topk_sweep`` runs
   ``torch_benchmarks/bench_am_topk.py``'s k sweep at the main path's
   width (1,024 queries, 2^20 rows of 256 3-bit symbols, k = 8, 16, 32,
   64, 128, 256), the fused tier held bitwise to the dense tier (the dense
   kernel's matrix in the stable two-key order) at every k, its output
   bytes Q*k*8, and prints both tiers' microseconds and output bytes; then
   its merge sweep at the sharded main path's geometry (64 queries at
   k = 10 against the same 2^20 rows, split over 2-64 banks of
   ``LocalMesh``), every merge bitwise ``am.search``, with each merge's
   microseconds and traffic;
4f. the dry-run: ``dryrun`` counts, on the meta device as one card,
   ``launch.dryrun.run_cell`` for yi-6b's prefill at B = 1, S = 4,096
   (einsum, and with flash's score bytes dropped) and for train_yi6b's
   step, and prints each cell's ``t_bound`` beside the seconds measured
   for it in phases 4b and 4c (the 80 production cells are host counts
   that the card does not change: ``python -m repro_torch.launch.dryrun
   --all`` on any CPU);
5. each kernel held against its plain version and timed with CUDA events
   at the shapes its paths gave it, beside its bound, its plain version
   and a library call where one computes the same thing (the CAM kernels
   also at ``topk_sweep``'s Q = 1,024 against its 2^20-row table, the
   fused kernel at each k of the sweep, and the benchmark's two tiers
   held to the same plain results there, and at the HDC cell's 4,096
   queries against 26 class rows, where it takes the few-row pass, as
   device time beside its popc bound); ``hdc_encode``
   also against ``torch.matmul``'s time for the product alone, and
   ``hdc_encode`` and ``mibo_mc`` also as device time (a CUDA graph of
   launches) beside the time per call.

Phase 2 also holds ``flash_attention`` against its plain version at the
shapes of ``tests/test_flash_attention.py`` (float32 at 2e-5, bfloat16 at
3e-2 and each row at a relative L2 error of 2e-2), at dh = 8, at the
prefill shape, and in bfloat16 (the tensor-core kernel) at each padded
head width.  Every path of phases 3, 3b, 3c, 3d and 4 (4b-4f too)
runs with the launch counts of every kernel set to 0 just before it and
read just after, and must launch its kernels (phase 4c's and 4f's
none).
It imports nothing of the JAX package.  Needs one CUDA card, ``nvcc`` and
``nvidia-smi``; the build goes to ``build/repro_torch/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20231007

# The H100's peaks (HBM bytes/s, int8, bf16, TF32 and float32 rates) are
# repro_torch.roofline.model's, imported where a bound is computed.

WIDTH, BITS = 256, 3
CAPACITY, ROWS, CHUNK = 1 << 20, 1_000_000, 65_536
LOOKUPS, K = 4096, 10

# The IVF tier: S ~ sqrt(N) sets of the 1,000,000-row table, 8 probes, one
# hyperplane projection (k-means is host numpy at O(N S D) a step); the
# exact path's k-means index of 64 sets over 65,536 rows
IVF_SETS, IVF_PROBES = 1024, 8
IVF_PLAIN_SAMPLE = 64          # ivf_k10 queries held against a plain search
IVF_EXACT_ROWS, IVF_EXACT_SETS, IVF_EXACT_QUERIES = 65_536, 64, 256

# multi-bank sharding: the banks of the local mesh (slices of the one card)
# and the query group each merge is timed at
SHARD_BANKS, SHARD_GROUP = 8, 1024
MERGES = ("allgather", "tree", "ring")

# durability: phase 3's snapshot and lm_serve's, under build/ (which
# .gitignore lists), each deleted at the end of its path
DURABLE_DIR = os.path.join(ROOT, "build", "durable_snapshot")
DURABLE_SERVE_DIR = os.path.join(ROOT, "build", "durable_serve")

# LPM: 32-bit addresses as 16 two-bit symbols (D = 16 is the kernels'
# D_MULTIPLE, so no padding), 2^17 routes (a full IPv4 table holds about
# 10^6: the python build loop and the oracle set the size), prefix lengths
# weighted toward /24 as in public BGP tables (RouteViews, the CIDR Report)
LPM_WIDTH, LPM_BITS, LPM_ROUTES, LPM_ADDRS = 16, 2, 1 << 17, 4096
LPM_MATCHES, LPM_MATCHES_ALL, LPM_ORACLE_SAMPLE = 8, 33, 64
LPM_LENGTH_WEIGHTS = {8: 0.2, 9: 0.1, 10: 0.2, 11: 0.4, 12: 0.8, 13: 1.5,
                      14: 2.5, 15: 4.5, 16: 8.5, 17: 4.0, 18: 7.0, 19: 13.0,
                      20: 21.0, 21: 24.0, 22: 61.0, 23: 55.0, 24: 357.0,
                      25: 0.3, 26: 0.3, 27: 0.2, 28: 0.2, 29: 0.2, 30: 0.2,
                      31: 0.1, 32: 0.3}

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

# training (phase 4c).  yi-6b's training state is 16 bytes a parameter
# (bf16 weight 2 + float32 master 4 + m 4 + v 4 + bf16 gradient 2): 5.80 B
# parameters need 92.8 GB, more than the card holds, so the main training
# path keeps the full width and cuts the depth to 16 of the 32 layers
# (3.03 B parameters, 48.5 GB of state, about 30 GB left for activations
# under per-block recompute).  Full depth needs the optimizer state
# sharded over several cards.
STATE_BYTES_PER_PARAM = 16
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 2, 2048, 6
TRAIN_CKPT_DIR = os.path.join(ROOT, "build", "train_ckpt")
# the data-parallel step with the optimizer state sharded over data
# (train_fsdp): the bitwise optimizer gate at full width and 4 layers
# (0.954 B params, two states of 15.3 GB at once), then train_yi6b's run
# with its batch split over data = 2 (one state at a time: 48.5 GB does
# not fit twice), and the per-rank state of full-depth yi-6b at each of
# FSDP_WIDTHS by arithmetic from state_specs.  Each step's loss and
# grad_norm are held to train_yi6b's: step 1's within FSDP_FIRST_RTOL (the
# same weights and batch; the slices' bf16 forwards at B = 1 round apart
# from the one at B = 2; read on an H100 80GB HBM3 at 700 W: 1.1e-7 and
# 2.3e-6), which a gradient off by a constant factor would miss by far;
# later steps within FSDP_STEP_RTOL, since the bf16 gradient summed over
# two slices rounds apart from the whole batch's and the weights drift
# apart from step 2 on (read at most 9.2e-4)
FSDP_WIDTH, FSDP_GATE_LAYERS = 2, 4
FSDP_FIRST_RTOL, FSDP_STEP_RTOL = 2e-5, 5e-3
FSDP_WIDTHS = (1, 2, 4, 8)
# card against CPU, float32 smoke config, 3 steps under the default OptCfg
# (warmup 100: the parameters move by about 3e-6 a step)
CARD_CPU_LOSS_RTOL, CARD_CPU_PARAM_ATOL = 1e-4, 1e-5
# the compressed step: full width, 4 layers, 2 pods of B = 2, S = 512
COMP_LAYERS, COMP_BATCH, COMP_SEQ, COMP_STEPS = 4, 4, 512, 4
# the GPipe forward: 8 full-width blocks, 2 stages, 4 microbatches
PP_LAYERS, PP_STAGES, PP_MICRO, PP_SEQ = 8, 2, 4, 1024
# phase 4d: the other families at full width and depth.  deepseek's
# prefill at the length of SHAPES["train_4k"]; pixtral's 256 stub patch
# embeddings + 3,840 tokens make the same 4,096 positions; recurrentgemma
# over two of its 2,048-token windows, then 64 tokens decoded; xlstm's
# forward at B = 4, S = 2,048, trained at S = 256 (its sLSTM loop over
# time holds a step to 13.1 s at S = 2,048 and 3.9 s at S = 512 on the
# H100); granite-moe and musicgen at S = 1,024 (the
# stub prefix included), 4 tokens decoded
MOE_ARCH, MLA_SEQ = "deepseek-v2-lite-16b", 4096
VLM_ARCH, VLM_TOKENS = "pixtral-12b", 3840
HYBRID_ARCH, HYBRID_SEQ, HYBRID_DECODE = "recurrentgemma-2b", 4096, 64
XLSTM_ARCH, XLSTM_BATCH, XLSTM_SEQ = "xlstm-125m", 4, 2048
XLSTM_TRAIN_SEQ, XLSTM_STEPS, XLSTM_DECODE = 256, 6, 32
SWEEP_SEQ, SWEEP_DECODE = 1024, 4
SWEEP = (("granite-moe-1b-a400m", "family_sweep_granite_moe"),
         ("musicgen-medium", "family_sweep_musicgen"))
# layer by layer on one forward's own inputs (``_layer_walk``): an MoE
# block through EP against the dense oracle (bf16 rounding of the two
# combines; 2.8e-3 on the CPU smoke config), the flash kernel's attention
# against einsum's (the kernel's own row gate, FLASH_BF16_ROW_REL)
MOE_LAYER_REL_L2 = 1e-2
FLASH_LAYER_REL_L2 = 2e-2
# the RG-LRU's log-depth scan against the step-by-step recurrence on the
# card, bf16 outputs: a few bf16 ulps (2^-8 relative each)
SCAN_REL_L2 = 1e-2
# phase 4e: torch_benchmarks/bench_am_topk.py's k sweep at the main path's
# width (Q = 1,024 queries against 2^20 rows of 256 3-bit symbols, k over
# the whole fused band) and its merge sweep at 2-64 banks over the same
# 2^20 rows, TOPK_MERGE_Q queries (a multiple of every bank count, so no
# ring chunk pads) at the main path's k, each call timed TOPK_ITERS times
# after one warm-up and then checked once
TOPK_Q, TOPK_N, TOPK_ITERS = 1024, 1 << 20, 5
TOPK_BANKS = (2, 4, 8, 16, 32, 64)
TOPK_MERGE_Q = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = _card()
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
        # at most 32 rows: the fused tier's few-row partial pass
        ("b3-few-rows", 3, 37, 26, 200, True, True, 13, 20, False),
        ("l1-few-rows", 3, 300, 26, 4096, False, False, None, 1, True),
    ]


def phase_kernels():
    import torch
    from repro_torch.kernels.cam_search import ops, ref
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    err = {"cam_search": 0.0, "cam_search_topk": 0.0, "cam_pack": 0.0,
           "cam_pack_l1": 0.0}
    for name, bits, qn, n, d, has_care, counted, vr, k, l1 in kernel_cases():
        m = 1 << bits
        codes = rng.integers(0, m, (n, d)).astype(np.int32)
        codes[1::7] = codes[0]                  # duplicate rows: ties
        q = rng.integers(0, m, (qn, d)).astype(np.int32)
        q[0] = codes[0]
        care = ((rng.random((n, d)) > 0.25).astype(np.int32)
                if has_care else None)
        t_q = torch.from_numpy(q).to(dev).to(torch.int8)
        t_t = torch.from_numpy(codes).to(dev).to(torch.int8)
        t_c = None if care is None else torch.from_numpy(care).to(dev)
        # plain: an L1 search's level codes counted on their thermometer
        # expansion at one bit; the kernels take the codes (the L1 pack)
        p_q, p_t, p_c = t_q, t_t, t_c
        if l1:
            p_q, p_t = (torch.from_numpy(_thermo(x, bits)).to(dev)
                        .to(torch.int8) for x in (q, codes))
            if care is not None:
                p_c = torch.from_numpy(np.repeat(care, m - 1, axis=-1)).to(dev)
        thr = None
        if counted:
            thr = torch.from_numpy(
                rng.integers(0, d // 2, (qn, 1)).astype(np.float32)).to(dev)
        # dense tier
        want = ref.mismatch_counts(p_q, p_t, p_c)
        for tile in _tiles(qn):
            with _query_tile(tile):
                got = ops.mismatch_counts(t_q, t_t, bits, care=t_c, l1=l1)
            torch.cuda.synchronize()
            check(got.dtype == torch.int32
                  and got.shape == (qn, codes.shape[0]),
                  f"{name}: dense dtype/shape {got.dtype} {tuple(got.shape)}")
            diff = (got.long() - want.long()).abs().max().item()
            err["cam_search"] = max(err["cam_search"], float(diff))
            check(diff == 0,
                  f"{name}/{tile}: cam_search differs from plain by {diff}")
        # fused tier
        want = ref.topk(p_q, p_t, k, valid_rows=vr, care=p_c, count_le=thr)
        for tile in _tiles(qn):
            with _query_tile(tile):
                got = ops.topk_fused(t_q, t_t, k, bits, valid_rows=vr,
                                     care=t_c, count_le=thr, l1=l1)
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
            (7, 33, 2000, 64, True, 10, 1999),
            (7, 21, 30, 48, True, 30, 25)]          # the few-row pass


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


def _ivf_launches(launches, groups):
    """The launch rule of an indexed table: per group one coarse dense
    search, and one fine fused search per distinct non-empty probed set
    (at least one, at most ``IVF_SETS``), each with its pack; the sets'
    slabs hold far more than 32 rows, so no few-row pass.
    :func:`_ivf_k10_checks` narrows the fine count with the probed sets,
    and :func:`_ivf_group_split` checks each stage's count exactly."""
    fine = launches["cam_search_topk"]
    return (launches["cam_search"] == groups
            and groups <= fine <= groups * IVF_SETS
            and launches["cam_pack"] == groups + fine
            and launches["cam_search_topk_few"] == 0
            and all(n == 0 for name, n in launches.items()
                    if not name.startswith("cam_")))


def _drive(svc, path, table, queries, *, indexed=False, banks=1, **kw):
    """One path: submit ``queries`` to ``table`` and wait for them all.

    The launch counts are set to 0 just before the first submit and read
    just after the last lookup resolved, so they are this path's alone; the
    groups it dispatched are read from the table's bucket counts.  Each
    group is one search, which launches the pack kernel (the L1 pack on a
    multi-bit L1 table) and one search kernel once per bank (``banks`` of a
    sharded service): the fused one, or the dense one for k above 256.  An
    ``indexed`` table's groups follow :func:`_ivf_launches` instead.
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
    if indexed:
        check(_ivf_launches(launches, groups), f"{path}: launches "
              f"{launches} break the index tier's rule for {groups} groups")
    else:
        tier = ("cam_search" if kw.get("k", 1) > am.FUSED_K_MAX
                else "cam_search_topk")
        t = svc._tables[table].table
        pack = ("cam_pack_l1" if t.distance == "l1" and t.bits > 1
                else "cam_pack")
        want = {name: groups * banks if name in (tier, pack) else 0
                for name in launches}
        check(launches == want, f"{path}: launches {launches}, expected "
              f"{want} for {groups} groups")
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

    # the indexed table is filled and driven after every flat path, so the
    # flat paths run on the same service state as before the index existed
    ivf_fill = _fill_indexed(svc, stored)
    svc.start_driver(max_in_flight=2)
    ivf_futs, paths["ivf_k10"] = _drive(svc, "ivf_k10", "responses_ivf",
                                        queries, indexed=True, k=K)
    svc.stop_driver()

    resp = [f.result() for f in futs]
    paths["ivf_k10"].update(ivf_fill)
    paths["ivf_k10"].update(_ivf_k10_checks(svc, queries, resp, ivf_futs,
                                            paths, rows, exact, stored))
    svc.drop_table("responses_ivf")
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
            "queries": queries, "l1_queries": l1_codes[l1_rows],
            "stored": stored, "responses": resp, "tcam_query": base[7],
            "tcam_exact": exact_t}


def _fill_indexed(svc, stored):
    """The ``ivf_k10`` table: the 1,000,000 rows of ``responses`` in a
    2^20-row capacity behind the index tier, appended in CHUNK-row chunks.
    ``min_rows=ROWS`` makes the lazy build run once, inside the last
    append, rather than at the second chunk with every later chunk going
    through ``ivf.append``.  Returns the fill's seconds and the last
    append's (which holds the build)."""
    import torch
    from repro_torch.serve import IndexSpec
    spec = IndexSpec(sets=IVF_SETS, probes=IVF_PROBES, method="hyperplane",
                     min_rows=ROWS)
    svc.create_table("responses_ivf", width=WIDTH, bits=BITS,
                     distance="hamming", capacity=CAPACITY, policy="lru",
                     backend="cuda", index=spec)
    t0 = time.perf_counter()
    for s in range(0, ROWS, CHUNK):
        check(not svc.stats("responses_ivf")["index"]["built"],
              f"ivf_k10: index built before the fill ended (row {s})")
        t1 = time.perf_counter()
        svc.append("responses_ivf", stored[s:s + CHUNK].astype(np.int32),
                   values=list(range(s, min(ROWS, s + CHUNK))))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st = svc.stats("responses_ivf")["index"]
    check(st["built"] and st["builds"] == 1,
          f"ivf_k10: index after the fill {st}")
    index = svc._tables["responses_ivf"].index
    sizes = index.set_sizes.cpu().numpy()
    out = {"fill_s": t2 - t0, "build_s": t2 - t1, "sets": IVF_SETS,
           "probes": IVF_PROBES, "set_capacity": index.set_capacity,
           "set_size_min": int(sizes.min()), "set_size_max": int(sizes.max()),
           "empty_sets": int((sizes == 0).sum())}
    print(f"  responses_ivf: filled {ROWS} rows in {out['fill_s']:.2f} s, "
          f"the last append (it holds the build) {out['build_s']:.2f} s; "
          f"{IVF_SETS} sets of {sizes.min()}-{sizes.max()} rows "
          f"(slab capacity {index.set_capacity}, {out['empty_sets']} empty)")
    return out


def _ivf_group_split(index, queries, qb):
    """One group of ``qb`` queries through the index stage by stage, each
    stage's seconds on the host clock after a device sync: coarse (the
    dense kernel over the centroids), fine (one fused launch per distinct
    probed set, with the host's grouping) and merge; held bitwise against
    ``ivf.search`` on the same group."""
    import torch
    from repro_torch.core import am
    from repro_torch.index import ivf
    be = am._resolve_backend("cuda")
    q = torch.from_numpy(np.stack(queries[:qb])).cuda()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    probed, bound = ivf._coarse(index, q, IVF_PROBES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    coarse = read_launches()
    reset_launches()
    dist, gid = ivf._fine_candidates(be, q, index, probed,
                                     min(K, index.set_capacity))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fine = read_launches()
    reset_launches()
    dist, gid = ivf._merge(dist, gid, K)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    merge = read_launches()
    sets = np.unique(probed.cpu().numpy())
    live = int((index.set_sizes.cpu().numpy()[sets] > 0).sum())
    for stage, got, want in (
            ("coarse", coarse, {"cam_search": 1, "cam_pack": 1}),
            ("fine", fine, {"cam_search_topk": live, "cam_pack": live}),
            ("merge", merge, {})):
        want = {name: want.get(name, 0) for name in got}
        check(got == want, f"ivf_k10 group Q={qb}: {stage} launches {got}, "
              f"expected {want} ({live} distinct non-empty probed sets)")
    whole = ivf.search(index, q, k=K, probes=IVF_PROBES, backend="cuda")
    check(torch.equal(whole.indices, gid) and torch.equal(whole.distances,
                                                          dist),
          "ivf_k10: the staged group differs from ivf.search")
    return {"Q": qb, "coarse_s": t1 - t0, "fine_s": t2 - t1,
            "merge_s": t3 - t2,
            "fine_launches": fine["cam_search_topk"],
            "distinct_probed_sets": int(sets.size)}


def _ivf_against_plain(index, queries, probed, g_idx, g_dist, stored):
    """The indexed service held to a plain version built apart from the
    port's fine pass.  Every row lies in exactly one set; on a sample of
    queries the probe ranking equals the plain top-``IVF_PROBES`` over the
    centroids on the CPU, and the service's indices and distances equal the
    plain top-k over the probed sets' rows, taken from the host copy
    ``stored`` by global id and laid out in ascending id (so the plain
    search's row-position tie-break is the global-id one).  Returns the
    sample's size."""
    import torch
    from repro_torch.core import am
    row_ids = index.row_ids.cpu().numpy()
    sizes = index.set_sizes.cpu().numpy()
    members = [row_ids[s, :sizes[s]] for s in range(index.sets)]
    check(np.array_equal(np.sort(np.concatenate(members)), np.arange(ROWS)),
          "ivf_k10: the sets do not partition the table's rows")
    pick = np.random.default_rng(SEED + 2).choice(LOOKUPS, IVF_PLAIN_SAMPLE,
                                                  replace=False)
    q = np.stack([queries[i] for i in pick])
    cent = am.make_table(index.centroids.cpu(), bits=index.bits,
                         distance=index.distance, device="cpu")
    rank = am.search(cent, q, k=IVF_PROBES, backend="ref").indices.numpy()
    check(np.array_equal(rank, probed[pick]), "ivf_k10: the probe ranking "
          "differs from the plain search over the centroids")
    for j, i in enumerate(pick):
        gids = np.sort(np.concatenate([members[s] for s in rank[j]]))
        part = am.make_table(stored[gids].astype(np.int32), bits=BITS,
                             device="cpu")
        r = am.search(part, q[j], k=K, backend="ref")
        want_idx = gids[r.indices.numpy()].astype(np.int32)
        check(np.array_equal(g_idx[i], want_idx)
              and np.array_equal(g_dist[i], r.distances.numpy()),
              f"ivf_k10: lookup {i} differs from the plain top-{K} over its "
              f"{IVF_PROBES} probed sets ({gids.size} rows)")
    return int(pick.size)


def _ivf_k10_checks(svc, queries, flat, futs, paths, rows, exact, stored):
    """Gates and readings of ``ivf_k10``: on a sample, the service's results
    equal a plain top-k over the probed sets' rows (:func:`_ivf_against_
    plain`); all its results equal ``ivf.search``'s on the same queries;
    the path's fine launches lie between the distinct probed sets and that
    count once per group (each staged group counts them exactly); every
    slot the recall proxy certifies equals the flat search's (on uniform
    random codes the proxy certifies almost nothing, so this gate is nearly
    empty: the count is printed); a query equal to a stored row finds it
    first; ``stats()["index"]`` counts the lookups.  Reports recall@10
    against the flat search, the mean proxy and candidate fraction,
    lookups/s beside ``responses_k10``'s, and the per-group split."""
    import torch
    from repro_torch.index import ivf
    index = svc._tables["responses_ivf"].index
    got = [f.result() for f in futs]
    direct = ivf.search(index, np.stack(queries), k=K, probes=IVF_PROBES,
                        backend="cuda")
    d_idx = direct.indices.cpu().numpy()
    d_dist = direct.distances.cpu().numpy()
    proxy = direct.recall_proxy.cpu().numpy()
    frac = direct.candidate_fraction.cpu().numpy()
    g_idx = np.stack([r.indices for r in got])
    g_dist = np.stack([r.distances for r in got])
    check(np.array_equal(g_idx, d_idx) and np.array_equal(g_dist, d_dist),
          "ivf_k10: service results differ from ivf.search on the same "
          "queries")
    probed = direct.probed_sets.cpu().numpy()
    plain_n = _ivf_against_plain(index, queries, probed, g_idx, g_dist,
                                 stored)
    live = np.flatnonzero(index.set_sizes.cpu().numpy() > 0)
    distinct = int(np.intersect1d(np.unique(probed), live).size)
    fine = paths["ivf_k10"]["launches"]["cam_search_topk"]
    groups = sum(paths["ivf_k10"]["buckets"].values())
    check(distinct <= fine <= min(groups * distinct, LOOKUPS * IVF_PROBES),
          f"ivf_k10: {fine} fine launches for {distinct} distinct probed "
          f"sets over {groups} groups")
    f_idx = np.stack([r.indices for r in flat])
    f_dist = np.stack([r.distances for r in flat])
    # the proxy counts the certified slots, and certified distances are
    # the smallest ones: the first round(proxy * K) slots of each query
    cert = np.rint(proxy * K).astype(int)
    slot = np.arange(K)[None, :] < cert[:, None]
    bad = int((slot & (d_dist != f_dist)).sum())
    check(bad == 0, f"ivf_k10: {bad} certified slots differ from the flat "
          f"search")
    best = g_idx[:, 0]
    check(bool((best[exact] == rows[exact]).all()), "ivf_k10: a stored "
          "row's duplicate did not find it first")
    ist = svc.stats("responses_ivf")["index"]
    check(ist["lookups"] == LOOKUPS,
          f"ivf_k10: stats()['index'] counts {ist['lookups']} lookups")
    recall = float((d_dist == f_dist).mean())
    seconds = paths["ivf_k10"]["seconds"]
    flat_s = paths["responses_k10"]["seconds"]
    # each bucket size twice: the first call of a shape may pay the
    # allocator's growth, the second is the steady state
    split = [dict(_ivf_group_split(index, queries, qb), run=run)
             for qb in sorted(paths["ivf_k10"]["buckets"]) for run in (1, 2)]
    out = {"plain_sample": plain_n, "distinct_probed_sets": distinct,
           "recall_at_10": recall,
           "index_equal_share": float((d_idx == f_idx).mean()),
           "perturbed_source_found_share": float(
               (best[~exact] == rows[~exact]).mean()),
           "certified_slots": int(slot.sum()),
           "recall_proxy_mean": float(proxy.mean()),
           "candidate_fraction_mean": float(frac.mean()),
           "lookups_per_s": LOOKUPS / seconds,
           "flat_lookups_per_s": LOOKUPS / flat_s,
           "service_candidate_fraction": ist["candidate_fraction"],
           "group_split": split}
    print(f"  ivf_k10: {plain_n} sampled lookups equal the plain top-{K} "
          f"over their probed sets' rows; {fine} fine launches for "
          f"{distinct} distinct probed sets over {groups} groups")
    print(f"  ivf_k10: recall@10 {recall:.4f} against the flat search "
          f"(indices equal at {out['index_equal_share']:.4f}); every exact "
          f"query found its row first, a perturbed one its source at "
          f"{out['perturbed_source_found_share']:.4f}; recall proxy "
          f"mean {out['recall_proxy_mean']:.6f}, {out['certified_slots']} "
          f"of {LOOKUPS * K} slots certified, all equal to flat; candidate "
          f"fraction mean "
          f"{out['candidate_fraction_mean']:.5f}; {out['lookups_per_s']:.0f} "
          f"lookups/s against {out['flat_lookups_per_s']:.0f} flat")
    for g in split:
        print(f"  ivf_k10 group Q={g['Q']} (run {g['run']}): coarse "
              f"{g['coarse_s']:.4f} s, "
              f"fine {g['fine_s']:.4f} s ({g['fine_launches']} fused "
              f"launches over {g['distinct_probed_sets']} probed sets), "
              f"merge {g['merge_s']:.4f} s")
    del direct
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 3b: TCAM routing and the exact index
# ---------------------------------------------------------------------------

def _lpm_routes(rng):
    """A default route, then LPM_ROUTES - 1 seeded prefixes whose lengths
    follow LPM_LENGTH_WEIGHTS; next hops 1, 2, ... in route order."""
    from repro_torch import tcam
    lens = np.array(sorted(LPM_LENGTH_WEIGHTS))
    w = np.array([LPM_LENGTH_WEIGHTS[n] for n in lens])
    n = LPM_ROUTES - 1
    plen = rng.choice(lens, n, p=w / w.sum())
    vals = rng.integers(0, 1 << 32, n, dtype=np.int64)
    vals = (vals >> (32 - plen)) << (32 - plen)
    return [tcam.Route(0, 0, 0)] + [
        tcam.Route(int(v), int(p), i + 1)
        for i, (v, p) in enumerate(zip(vals.tolist(), plen.tolist()))]


def _lpm_v4():
    """Build the routing table and resolve the addresses three ways: at
    ``matches=8``, at ``matches=33`` (the most prefixes a 32-bit address
    can match) and on the table without its default route."""
    import torch
    from repro_torch.core import am
    from repro_torch import tcam
    rng = np.random.default_rng(SEED + 30)
    routes = _lpm_routes(rng)
    inside = rng.integers(1, LPM_ROUTES, LPM_ADDRS // 2)
    host = rng.integers(0, 1 << 32, LPM_ADDRS // 2, dtype=np.int64)
    addrs = np.concatenate([
        [routes[i].value | (int(h) & ((1 << (32 - routes[i].prefix_bits))
                                      - 1)) for i, h in zip(inside, host)],
        rng.integers(0, 1 << 32, LPM_ADDRS - LPM_ADDRS // 2,
                     dtype=np.int64)]).astype(np.int64)

    def path():
        t0 = time.perf_counter()
        rt = tcam.build_routing_table(routes, width=LPM_WIDTH, bits=LPM_BITS,
                                      default_hop=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hops, res = tcam.lookup(rt, addrs, matches=LPM_MATCHES,
                                backend="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wide, wres = tcam.lookup(rt, addrs, matches=LPM_MATCHES_ALL,
                                 backend="cuda")
        check(int(rt.prefix_lens[-1]) == 0 and int(rt.prefix_lens[-2]) > 0,
              "lpm_v4: the default route is not the last row alone")
        bare = dataclasses.replace(
            rt, table=am.AMTable(codes=rt.table.codes[:-1],
                                 care=rt.table.care[:-1], bits=LPM_BITS),
            next_hops=rt.next_hops[:-1], prefix_lens=rt.prefix_lens[:-1])
        bare_hops, bare_res = tcam.lookup(bare, addrs, matches=LPM_MATCHES,
                                          backend="cuda")
        torch.cuda.synchronize()
        return (rt, hops, res, wide, wres, bare_hops, bare_res,
                t1 - t0, t2 - t1)

    (rt, hops, res, wide, wres, bare_hops, bare_res, build_s,
     lookup_s), info = _run_path("lpm_v4", path,
                                 {"cam_search_topk": 3, "cam_pack": 3})
    hops, wide = hops.cpu().numpy(), wide.cpu().numpy()
    bare_hops = bare_hops.cpu().numpy()
    count = res.match_count.cpu().numpy()
    check(np.array_equal(hops, wide), "lpm_v4: hops change when matches "
          f"widens from {LPM_MATCHES} to {LPM_MATCHES_ALL}")
    check(not bool(wres.overflow.any()), f"lpm_v4: an address matched more "
          f"than {LPM_MATCHES_ALL} rules")
    check(np.array_equal(wres.match_count.cpu().numpy(), count),
          "lpm_v4: match counts change with the window")
    check(bool((count >= 1).all()), "lpm_v4: the default route did not "
          "match every address")
    none = bare_res.match_count.cpu().numpy() == 0
    check(bool((bare_hops[none] == rt.default_hop).all()),
          "lpm_v4: an address that matched nothing is not sent to "
          "default_hop")
    check(np.array_equal(bare_hops[~none], hops[~none]),
          "lpm_v4: dropping the default route changed a covered hop")
    check(np.array_equal(none, hops == 0), "lpm_v4: the addresses only the "
          "default route covers are not the unmatched ones")
    pick = np.random.default_rng(SEED + 31).choice(LPM_ADDRS,
                                                   LPM_ORACLE_SAMPLE,
                                                   replace=False)
    t0 = time.perf_counter()
    want = [tcam.lpm_oracle(routes, int(addrs[i]), width=LPM_WIDTH,
                            bits=LPM_BITS, default_hop=-1) for i in pick]
    oracle_s = time.perf_counter() - t0
    check(hops[pick].tolist() == want, "lpm_v4: hops differ from lpm_oracle")
    out = {"routes": LPM_ROUTES, "rows": rt.table.n_rows,
           "addresses": LPM_ADDRS, "matches": LPM_MATCHES,
           "overflow": int(res.overflow.sum()), "build_s": build_s,
           "lookup_s": lookup_s, "addresses_per_s": LPM_ADDRS / lookup_s,
           "unmatched_without_default": int(none.sum()),
           "max_match_count": int(count.max()),
           "oracle_sample": LPM_ORACLE_SAMPLE, "oracle_s": oracle_s}
    print(f"  lpm_v4: {LPM_ROUTES} routes -> {out['rows']} rows, build "
          f"{build_s:.2f} s, one lookup of {LPM_ADDRS} addresses "
          f"{lookup_s * 1e3:.2f} ms; overflow at matches={LPM_MATCHES}: "
          f"{out['overflow']}, up to {out['max_match_count']} matches; "
          f"{out['unmatched_without_default']} addresses matched only the "
          f"default route; {LPM_ORACLE_SAMPLE} sampled hops equal "
          f"lpm_oracle ({oracle_s:.1f} s)")
    info.update(out)
    return info


def _ivf_exact():
    """A k-means index over a 65,536-row table on the card, searched at
    probes = sets: bitwise the flat search, every slot certified; then the
    same search set-banked over a local mesh of ``SHARD_BANKS`` banks
    (``ivf_exact_sharded``), bitwise the flat search too.  Returns both
    paths' records."""
    import torch
    from repro_torch.core import am
    from repro_torch.dist import LocalMesh
    from repro_torch.index import ivf
    rng = np.random.default_rng(SEED + 40)
    codes = rng.integers(0, 1 << BITS, (IVF_EXACT_ROWS, WIDTH),
                         dtype=np.int32)
    rows = rng.integers(0, IVF_EXACT_ROWS, IVF_EXACT_QUERIES)
    queries = np.stack([codes[r] if i % 2 else
                        _perturb(rng, codes[r], 8, 1 << BITS)
                        for i, r in enumerate(rows)])
    table = am.make_table(codes, bits=BITS)

    def path():
        t0 = time.perf_counter()
        index = ivf.build(table, sets=IVF_EXACT_SETS, method="kmeans")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = ivf.search(index, queries, k=K, probes=IVF_EXACT_SETS,
                       backend="cuda")
        torch.cuda.synchronize()
        return index, r, t1 - t0, time.perf_counter() - t1

    def expect(out):
        fine = int((out[0].set_sizes > 0).sum())
        return {"cam_search_topk": 1 + fine, "cam_search": 1,
                "cam_pack": 2 + fine}

    (index, r, build_s, search_s), info = _run_path("ivf_exact", path,
                                                    expect)
    flat = am.search(table, queries, k=K, backend="cuda")
    check(torch.equal(r.indices, flat.indices)
          and torch.equal(r.distances, flat.distances),
          "ivf_exact: probes = sets differs from the flat search")
    check(bool((r.recall_proxy == 1.0).all()),
          "ivf_exact: a slot is not certified at probes = sets")
    sizes = index.set_sizes.cpu().numpy()
    out = {"rows": IVF_EXACT_ROWS, "sets": IVF_EXACT_SETS,
           "queries": IVF_EXACT_QUERIES, "build_s": build_s,
           "search_s": search_s, "set_capacity": index.set_capacity,
           "set_size_min": int(sizes.min()), "set_size_max": int(sizes.max())}
    print(f"  ivf_exact: k-means build {build_s:.2f} s ({IVF_EXACT_SETS} "
          f"sets of {sizes.min()}-{sizes.max()} rows), search at probes = "
          f"sets {search_s * 1e3:.1f} ms; indices and distances bitwise the "
          f"flat search, recall proxy 1.0 everywhere")
    info.update(out)

    # the same index, its sets banked over the local mesh: one coarse
    # launch, and each non-empty set searched once, by the bank owning it
    mesh = LocalMesh((SHARD_BANKS,), ("model",))

    def sharded():
        return ivf.search_sharded(index, queries, mesh=mesh, k=K,
                                  probes=IVF_EXACT_SETS, backend="cuda")

    fine = int((index.set_sizes > 0).sum())
    rs, info_sh = _run_path("ivf_exact_sharded", sharded,
                            {"cam_search_topk": fine, "cam_search": 1,
                             "cam_pack": 1 + fine})
    check(torch.equal(rs.indices, flat.indices)
          and torch.equal(rs.distances, flat.distances)
          and torch.equal(rs.recall_proxy, r.recall_proxy),
          "ivf_exact_sharded: the set-banked search differs from the flat "
          "search")
    info_sh.update(banks=SHARD_BANKS, queries=IVF_EXACT_QUERIES,
                   search_s=info_sh["seconds"])
    print(f"  ivf_exact_sharded: {SHARD_BANKS} banks of "
          f"{-(-IVF_EXACT_SETS // SHARD_BANKS)} sets, search "
          f"{info_sh['seconds'] * 1e3:.1f} ms; bitwise the flat search")
    return info, info_sh


def phase_tcam_ivf():
    import torch
    paths = {"lpm_v4": _lpm_v4()}
    paths["ivf_exact"], paths["ivf_exact_sharded"] = _ivf_exact()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 3c: multi-bank sharding and the paper's Fig. 12
# ---------------------------------------------------------------------------

def _sharded_k10(run):
    """The 1,000,000 rows of ``responses_k10`` in a service sharded over a
    local mesh of ``SHARD_BANKS`` banks, the same 4,096 lookups through the
    driver, each bitwise its flat result; then one ``SHARD_GROUP``-query
    group through ``am.search_sharded`` under each merge, bitwise
    ``am.search``, timed after a sync, with the merge alone timed on that
    group's per-bank candidates."""
    import torch
    from repro_torch.core import am
    from repro_torch.dist import LocalMesh
    from repro_torch.serve import AMService

    mesh = LocalMesh((SHARD_BANKS,), ("model",))
    svc = AMService(mesh=mesh, merge="auto", time_fn=time.monotonic)
    svc.create_table("responses", width=WIDTH, bits=BITS, distance="hamming",
                     capacity=CAPACITY, policy="lru", backend="cuda")
    stored = run["stored"]
    t0 = time.perf_counter()
    for s in range(0, ROWS, CHUNK):
        m = min(CHUNK, ROWS - s)
        svc.append("responses", stored[s:s + m].astype(np.int32),
                   values=list(range(s, s + m)))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    svc.start_driver(max_in_flight=2)
    futs, info = _drive(svc, "sharded_k10", "responses", run["queries"],
                        banks=SHARD_BANKS, k=K)
    svc.stop_driver()
    flat = run["responses"]
    for i, f in enumerate(futs):
        r = f.result()
        check(np.array_equal(r.indices, flat[i].indices)
              and np.array_equal(r.distances, flat[i].distances),
              f"sharded_k10 lookup {i} differs from responses_k10")
    stats = svc.stats()
    check(stats["sharded"] and stats["merge"] == "auto",
          f"sharded_k10: stats {stats['sharded']}, {stats['merge']}")
    groups = sum(info["buckets"].values())
    rate = LOOKUPS / info["seconds"]
    flat_rate = run["service"]["lookups_per_s"]
    print(f"  sharded_k10: {SHARD_BANKS} banks, merge auto -> "
          f"{am.resolve_merge('auto', SHARD_BANKS, K)}, {rate:.0f} lookups/s "
          f"(responses_k10 {flat_rate:.0f}), launches per group "
          f"{ {n: c // groups for n, c in info['launches'].items() if c} }, "
          f"all {LOOKUPS:,} bitwise the flat results; fill {fill_s:.2f} s")

    # one group under each merge, against the flat search
    table = svc._tables["responses"].table
    q = torch.from_numpy(np.stack(run["queries"][:SHARD_GROUP])).cuda()
    want = am.search(table, q, k=K, backend="cuda", valid_rows=ROWS)
    be = am._resolve_backend("cuda")
    local_n = -(-table.n_rows // SHARD_BANKS)
    parts = [am._bank_candidates(be, table, q, b * local_n, local_n, K,
                                 ROWS, None)
             for b in range(SHARD_BANKS)]
    cand = (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))
    merges = {}
    for merge in MERGES:
        reset_launches()
        got = am.search_sharded(table, q, mesh=mesh, k=K, backend="cuda",
                                valid_rows=ROWS, merge=merge)
        torch.cuda.synchronize()
        launches = read_launches()
        check(torch.equal(got.indices, want.indices)
              and torch.equal(got.distances, want.distances),
              f"search_sharded merge={merge} differs from am.search")
        per_group = {n: c for n, c in launches.items() if c}
        check(per_group == {"cam_pack": SHARD_BANKS,
                            "cam_search_topk": SHARD_BANKS},
              f"search_sharded merge={merge}: launches {launches}")
        group_ms = _time_ms(lambda: am.search_sharded(
            table, q, mesh=mesh, k=K, backend="cuda", valid_rows=ROWS,
            merge=merge), 5)
        merge_ms = _time_ms(lambda: am._merge_bank_candidates(
            *cand, mesh=mesh, axis="model", n_banks=SHARD_BANKS, k=K,
            strategy=merge), 5)
        merges[merge] = {"group_ms": group_ms, "merge_ms": merge_ms,
                         "merge_share": merge_ms / group_ms,
                         "launches": per_group,
                         "traffic_bytes": am.merge_traffic_bytes(
                             SHARD_BANKS, SHARD_GROUP, K, merge=merge,
                             n_rows=table.n_rows)}
        print(f"  search_sharded Q={SHARD_GROUP} merge={merge}: group "
              f"{group_ms:.3f} ms, merge {merge_ms:.3f} ms "
              f"({100 * merge_ms / group_ms:.1f} % of the group), launches "
              f"{per_group}; bitwise am.search")
    flat_ms = _time_ms(lambda: am.search(table, q, k=K, backend="cuda",
                                         valid_rows=ROWS), 5)
    print(f"  am.search Q={SHARD_GROUP} on the same table: {flat_ms:.3f} ms")
    svc.drop_table("responses")
    torch.cuda.empty_cache()
    info.update(banks=SHARD_BANKS, lookups_per_s=rate,
                flat_lookups_per_s=flat_rate, fill_s=fill_s, merges=merges,
                flat_group_ms=flat_ms)
    return info


def _fig12():
    """``torch_benchmarks.fig12_speedup.run()`` at its full shapes, its CSV
    lines printed; the measured search of the first shape held bitwise to
    the plain top-1 on the CPU."""
    import torch
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import kernel
    from torch_benchmarks import fig12_speedup as fig12

    def expect(rows):
        # K = 12 or 26 class rows: the few-row partial pass, every search
        n = sum(r["searches"] for r in rows)
        few = sum(r["searches"] for r in rows
                  if r["k_classes"] <= kernel.FEW_ROWS_MAX)
        return {"cam_search_topk": n, "cam_search_topk_few": few,
                "cam_pack": n}

    rows, info = _run_path("fig12", fig12.run, expect)
    first = rows[0]
    codes, queries = fig12.make_case(first["k_classes"], first["d"],
                                     first["batch"])
    got = fig12.top1(am.make_table(codes, bits=3),
                     torch.from_numpy(queries).cuda())
    want = am.search(am.make_table(codes, bits=3, device="cpu"), queries,
                     k=1, backend="ref")
    check(torch.equal(got.indices.cpu(), want.indices)
          and torch.equal(got.distances.cpu(), want.distances),
          "fig12: the measured search differs from the plain top-1")
    info["rows"] = rows
    return info


def phase_sharded(run):
    return {"sharded_k10": _sharded_k10(run), "fig12": _fig12()}


# ---------------------------------------------------------------------------
# phase 3d: durability at full size
# ---------------------------------------------------------------------------

def _disk_bytes(directory):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(directory) for f in files)


def _same_response(a, b):
    return (np.array_equal(a.indices, b.indices)
            and a.distances.tobytes() == b.distances.tobytes()
            and np.array_equal(a.exact, b.exact)
            and a.match_count == b.match_count and a.overflow == b.overflow)


def _durable_path(run, path, mesh=None, banks=1):
    """Restore phase 3's snapshot (onto ``mesh`` when given) with a wall
    clock; time ``restore()`` and the first resolved lookup after it; drive
    the 4,096 lookups of ``responses_k10`` through the driver, each bitwise
    its ``responses_k10`` result, and the ``tcam`` table's ``matches=16``
    lookup, equal to the one before the snapshot."""
    import torch
    from repro_torch.serve import AMService
    queries, flat = run["queries"], run["responses"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = AMService.restore(DURABLE_DIR, mesh=mesh, time_fn=time.monotonic)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    first = svc.lookup("responses", queries[0], k=K)
    first_s = time.perf_counter() - t0
    check(_same_response(first, flat[0]),
          f"{path}: the first lookup after restore() differs")
    for name, t in run["svc"]._tables.items():
        got = svc._tables[name]
        check(got.n == t.n and got.version == t.version
              and got.values == t.values,
              f"{path}: table {name!r} restored with other state")
    svc.start_driver(max_in_flight=2)
    futs, info = _drive(svc, path, "responses", queries, banks=banks, k=K)
    svc.stop_driver()
    for i, f in enumerate(futs):
        check(_same_response(f.result(), flat[i]),
              f"{path} lookup {i} differs from responses_k10")
    tcam = svc.lookup("tcam", run["tcam_query"], matches=16)
    check(_same_response(tcam, run["tcam_exact"]),
          f"{path}: the tcam matches=16 lookup differs from before the "
          "snapshot")
    rate = LOOKUPS / info["seconds"]
    flat_rate = run["service"]["lookups_per_s"]
    groups = sum(info["buckets"].values())
    print(f"  {path}: restore() {restore_s:.3f} s, to the first resolved "
          f"lookup {first_s:.3f} s; {rate:.0f} lookups/s (responses_k10 "
          f"{flat_rate:.0f}), launches per group "
          f"{ {n: c // groups for n, c in info['launches'].items() if c} }, "
          f"all {LOOKUPS:,} bitwise responses_k10, tcam lookup equal")
    del svc
    torch.cuda.empty_cache()
    info.update(banks=banks, restore_s=restore_s, first_lookup_s=first_s,
                lookups_per_s=rate, flat_lookups_per_s=flat_rate)
    return info


def phase_durable(run, card):
    """``durable_k10``: snapshot phase 3's service (``responses``, ``l1``
    and ``tcam``) under ``build/``, restore it on the card with no mesh and
    onto ``LocalMesh((8,), ("model",))``, each restore driving the
    ``responses_k10`` lookups; the directory is deleted at the end."""
    import shutil
    from repro_torch.dist import LocalMesh
    svc = run["svc"]
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        step = svc.snapshot(DURABLE_DIR)
        snap_s = time.perf_counter() - t0
        stages = svc._last_snapshot
        disk = _disk_bytes(DURABLE_DIR)
        held = sum(p.numel() * p.element_size()
                   for t in svc._tables.values()
                   for p in (t.table.codes, t.table.meta, t.table.care)
                   if p is not None)
        print(f"  durable_k10 snapshot on {card}: step {step}, "
              f"{len(svc._tables)} tables ({', '.join(svc._tables)}), "
              f"{disk:,} bytes on disk for {held:,} bytes of planes; "
              f"{snap_s:.3f} s = drain+capture "
              f"{stages['drain_capture_s']:.4f} s + write+fsync "
              f"{stages['write_s']:.3f} s")
        paths = {"durable_k10": _durable_path(run, "durable_k10"),
                 "durable_k10_mesh8": _durable_path(
                     run, "durable_k10_mesh8",
                     LocalMesh((SHARD_BANKS,), ("model",)), SHARD_BANKS)}
    finally:
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    paths["durable_k10"].update(
        snapshot_s=snap_s, drain_capture_s=stages["drain_capture_s"],
        write_s=stages["write_s"], disk_bytes=disk, plane_bytes=held,
        tables=list(svc._tables))
    return paths


# ---------------------------------------------------------------------------
# phase 4: the HDC application and the device model
# ---------------------------------------------------------------------------

def _run_path(path, fn, expect):
    """Run one path with every launch count zeroed just before and read
    just after.  ``expect`` maps each kernel the path must launch to its
    exact launch count (or is a function of the path's output that returns
    that map); every other kernel must not launch."""
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    import torch
    torch.cuda.synchronize()         # the path's work is done when timed
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if callable(expect):
        expect = expect(out)
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
    # L1 searches of multi-bit codes take the L1 pack (ucihar: 3 bits, 1 bit);
    # every search, over 26 (isolet) or 12 (ucihar) class rows, the few-row
    # partial pass
    n_l1 = sum(b > 1 for _, b in set(HDC_FIG11A + HDC_FIG11B)) + 1
    (accs, cam_calls), paths["hdc_isolet"] = _run_path(
        "hdc_isolet", lambda: _hdc_isolet(data),
        {"cam_search_topk": n_cam, "cam_search_topk_few": n_cam,
         "cam_pack": n_cam - n_l1, "cam_pack_l1": n_l1})
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
    with torch.no_grad():
        (logits, aux), path = _run_path(
            "lm_prefill", lambda: transformer.forward(params, flash, tokens),
            {"flash_attention": cfg.n_layers})
    check(logits.shape == (1, LM_SEQ, cfg.vocab_padded),
          f"lm_prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "lm_prefill: non-finite logits")
    t0 = time.perf_counter()
    with torch.no_grad():
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


def _lm_gate(r, path="lm_prefill", against="the einsum forward",
             rel_l2=True):
    """Argmax agreement at ``LM_ARGMAX_AGREEMENT`` or more and, with
    ``rel_l2``, the relative L2 difference at ``LM_LOGIT_REL_L2`` or
    less."""
    check(r["argmax_agreement"] >= LM_ARGMAX_AGREEMENT, f"{path}: argmax "
          f"agrees with {against} at {r['argmax_agreement']:.4f} of "
          f"positions")
    check(not rel_l2 or r["logit_rel_l2"] <= LM_LOGIT_REL_L2,
          f"{path}: logits differ "
          f"from {against}'s by a relative L2 of "
          f"{r['logit_rel_l2']:.3e} without the input token's column")


def _decode_against_forward(path, cfg, params, prompt, mesh=None,
                            elementwise=True):
    """A fresh one-slot engine fed ``prompt`` token by token: its last
    logits against the forward's at the last position, printed, then held.
    The greedy tokens must be equal unless the forward's top-2 margin is
    within twice the largest logit difference, where bf16 rounding may
    flip a near-tie.  ``elementwise``: the logits at the reference's
    decode-vs-forward tolerance (atol 0.55, rtol 0.05), which its smoke
    tests set for 2-3 layers and a 128-entry vocabulary; otherwise the
    relative L2 difference of the logits without the last input token's
    column at ``LM_LOGIT_REL_L2`` or less, as the prefill paths hold it
    (for an MoE config printed only: a route flipped by rounding moves a
    token's logits by O(1)).  A frontend architecture's forward gets an
    empty prefix (the engine decodes tokens only)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine
    eng = Engine.create(cfg, params, batch=1, max_len=max(32, len(prompt)),
                        mesh=mesh)
    t0 = time.perf_counter()
    got = eng.prefill(prompt[None])[0]            # ends in a copy to the host
    step_ms = (time.perf_counter() - t0) * 1e3 / len(prompt)
    embeds = (torch.zeros((1, 0, transformer.STUB_FRONTEND_DIM),
                          device="cuda") if cfg.frontend else None)
    with torch.no_grad():
        want, _ = transformer.forward(params, cfg,
                                      torch.from_numpy(prompt[None]).cuda(),
                                      embeds, mesh)
    want = want[0, -1, :cfg.vocab_size].float().cpu()
    diff = (got - want).abs()
    top2 = want.topk(2).values
    margin, delta = float(top2[0] - top2[1]), float(diff.max())
    same = int(got.argmax()) == int(want.argmax())
    g, w = got.clone(), want.clone()
    g[int(prompt[-1])] = w[int(prompt[-1])] = 0.0
    rel = float((g - w).norm() / w.norm())
    out = {"prompt_len": len(prompt), "engine_token": int(got.argmax()),
           "forward_token": int(want.argmax()), "equal": same,
           "top2_margin": margin, "max_abs_logit_diff": delta,
           "logit_rel_l2": rel, "engine_ms_per_step": step_ms}
    if not elementwise:
        print(f"  {path}: engine decode of {len(prompt)} tokens vs forward "
              f"{json.dumps(out)}")
    if elementwise:
        check(bool((diff <= 0.55 + 0.05 * want.abs()).all()),
              f"{path}: engine logits differ from forward by up to "
              f"{delta:.3f}")
    elif cfg.moe is None:
        check(rel <= LM_LOGIT_REL_L2, f"{path}: engine logits differ from "
              f"the forward's by a relative L2 of {rel:.3e}")
    check(same or margin <= 2 * delta, f"{path}: greedy token "
          f"{int(got.argmax())} != forward argmax {int(want.argmax())} "
          f"at top-2 margin {margin:.3f} > 2 x {delta:.3f}")
    return out


def _engine_against_forward(out, n=2, path="lm_serve", elementwise=True):
    """:func:`_decode_against_forward` for the first ``n`` distinct
    prompts of the served workload, on the served engine's weights and
    mesh."""
    eng0 = out["engine"]
    prompts = []
    for p in out["workload"]:
        if not any(np.array_equal(p, q) for q in prompts):
            prompts.append(p)
    return [_decode_against_forward(path, eng0.cfg, eng0.params, p,
                                    eng0.mesh, elementwise)
            for p in prompts[:n]]


def _lm_warm_restart(out):
    """``--am-restore`` on the directory ``lm_serve``'s
    ``--am-snapshot-dir`` committed: ``build_cache_service`` must bring
    back the cache's rows, and the key of a generated prompt must hit with
    its generation.  No model is loaded."""
    import shutil
    from repro_torch.core import hdc
    from repro_torch.launch import serve as launch_serve
    args = launch_serve.parse_args(["--arch", LM_ARCH, "--full",
                                    "--am-snapshot-dir", DURABLE_SERVE_DIR,
                                    "--am-restore"])
    t0 = time.perf_counter()
    svc = launch_serve.build_cache_service(args, start_driver=False)
    restore_s = time.perf_counter() - t0
    try:
        rows = svc.stats("responses")["rows"]
        check(rows == out["cache"]["rows"], f"lm_serve --am-restore: "
              f"{rows} rows, the served cache held {out['cache']['rows']}")
        rid = out["generated"][0]
        proj = hdc.token_key_projection(out["engine"].cfg.vocab_size,
                                        launch_serve.CACHE_DIM)
        key = hdc.prompt_key(proj, out["workload"][rid],
                             launch_serve.CACHE_BITS).cpu().numpy()
        resp = svc.lookup("responses", key)
        check(resp.hit and np.array_equal(resp.value, out["results"][rid]),
              "lm_serve --am-restore: a stored prompt's key missed")
    finally:
        svc.close()
        shutil.rmtree(DURABLE_SERVE_DIR, ignore_errors=True)
    return {"rows": rows, "restore_s": restore_s, "hit": True}


def _serve_path(path, argv):
    """``launch.serve.main(argv)`` with the launch counts zeroed before and
    read after: one ``cam_pack`` and one ``cam_search_topk`` per lookup
    group of the AM cache (a few-row pass too: its default capacity is 8
    rows) and no other kernel; all 6 requests answered, repeats served
    from the cache.  Returns (output, launches, seconds, lookup groups)."""
    import torch
    from repro_torch.kernels.cam_search import kernel
    from repro_torch.launch import serve as launch_serve
    reset_launches()
    t0 = time.perf_counter()
    out = launch_serve.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    cache = out["cache"]
    groups = sum(cache["buckets"].values())
    few = cache["capacity"] <= kernel.FEW_ROWS_MAX
    want = {name: groups if name in ("cam_search_topk", "cam_pack")
            or (few and name == "cam_search_topk_few") else 0
            for name in launches}
    check(launches == want, f"{path}: launches {launches}, expected "
          f"{want} for {groups} lookup groups")
    check(sorted(out["results"]) == list(range(6)),
          f"{path} answered {sorted(out['results'])}")
    check(cache["hits"] > 0, f"{path}: no repeat was served from the cache")
    return out, launches, seconds, groups


def _lm_serve():
    """The serving driver at full width, launch counts read around it, its
    cache snapshotted on exit and warm-restarted after."""
    import shutil
    shutil.rmtree(DURABLE_SERVE_DIR, ignore_errors=True)
    out, launches, seconds, groups = _serve_path(
        "lm_serve", ["--arch", LM_ARCH, "--full", "--am-snapshot-dir",
                     DURABLE_SERVE_DIR])
    cache = out["cache"]
    warm = _lm_warm_restart(out)
    checks = _engine_against_forward(out)
    print(f"  lm_serve: launches {launches}, {seconds:.3f} s; 6/6 answered, "
          f"{len(out['generated'])} generated in {out['ticks']} ticks, cache "
          f"{cache['hits']}/{cache['lookups']} hits; --am-restore brought "
          f"back {warm['rows']} rows in {warm['restore_s']:.3f} s and a "
          f"stored key hit; engine vs forward {json.dumps(checks)}")
    return {"launches": launches, "seconds": seconds, "groups": groups,
            "answered": len(out["results"]), "generated": len(out["generated"]),
            "ticks": out["ticks"], "hits": cache["hits"],
            "lookups": cache["lookups"], "warm_restart": warm,
            "engine_vs_forward": checks}


def phase_lm():
    import torch
    paths = {"lm_prefill": _lm_prefill()}
    torch.cuda.empty_cache()
    paths["lm_serve"] = _lm_serve()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 4c: training
# ---------------------------------------------------------------------------

def _mem_before(path):
    """Print the card's free memory before a training path and zero the
    peak counter."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    print(f"  {path}: mem_get_info free {free / 1e9:.2f} of "
          f"{total / 1e9:.2f} GB")
    return free


def _mem_after(path, reading):
    import torch
    peak = torch.cuda.max_memory_allocated()
    print(f"  {path}: max_memory_allocated {peak / 1e9:.2f} GB")
    reading["peak_bytes"] = peak
    return reading


def _events(n):
    import torch
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _param_sample(state):
    """Clones of the embedding's first rows and one layer's ``wq``."""
    return (state.params.embed[:8].detach().clone(),
            state.params.blocks[-1].attn.wq[:8].detach().clone())


def _changed(before, state):
    import torch
    return all(not torch.equal(a, b)
               for a, b in zip(before, _param_sample(state)))


def _profiled_step(step, state, batch, top=12):
    """One more training step under ``torch.profiler``
    (:func:`_profiled`)."""
    return _profiled(lambda: step(state, batch), top)


def _profiled(fn, top=12):
    """``fn()`` under ``torch.profiler``: its wall ms, the device's busy ms
    (the kernels' device time summed) and the ``top`` ops by the device
    time of the kernels each launched itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    busy = sum(dev_us(e) for e in avgs if e.device_type == DeviceType.CUDA)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                 key=dev_us, reverse=True)
    return {"wall_ms": wall * 1e3, "device_ms": busy / 1e3,
            "top": [{"op": e.key, "device_ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in ops[:top]]}


def _train_yi6b():
    """yi-6b at full width and 16 of its 32 layers: 6 steps of
    ``make_train_step`` at B = 2, S = 2,048, each split into forward +
    backward and optimizer by CUDA events."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm_synth
    from repro_torch.roofline import model as roof
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.models import transformer
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    full_params = sum(p.numel() for p in
                      transformer.LM(full, device="meta").parameters())
    free = _mem_before("train_yi6b")
    state = ts.init_state(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"  train_yi6b: {cfg.name} at full width, {TRAIN_LAYERS} of its "
          f"{full.n_layers} layers (cut: {full_params / 1e9:.2f} B params x "
          f"{STATE_BYTES_PER_PARAM} B of state = "
          f"{full_params * STATE_BYTES_PER_PARAM / 1e9:.1f} GB exceeds the "
          f"card); {n_params / 1e9:.3f} B params, bf16 weights, float32 "
          f"master / m / v, remat {cfg.parallel.remat!r}")
    step = ts.make_train_step(cfg, opt.OptCfg(warmup_steps=2))
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=SEED)
    before = _param_sample(state)

    def run():
        rows = []
        for i in range(TRAIN_STEPS):
            batch = lm_synth.batch_at(data, i)
            e0, e1, e2 = _events(3)
            t0 = time.perf_counter()
            e0.record()
            grads, metrics = step.grads(state, batch)
            e1.record()
            step.update(state, grads, metrics)
            e2.record()
            del grads
            e2.synchronize()
            rows.append({"step_s": e0.elapsed_time(e2) / 1e3,
                         "fwd_bwd_s": e0.elapsed_time(e1) / 1e3,
                         "optimizer_s": e1.elapsed_time(e2) / 1e3,
                         "host_s": time.perf_counter() - t0,
                         "loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"]),
                         "lr": float(metrics["lr"])})
        return rows, _profiled_step(step, state,
                                    lm_synth.batch_at(data, TRAIN_STEPS))

    (rows, prof), path = _run_path("train_yi6b", run, {})
    losses = [r["loss"] for r in rows]
    check(all(np.isfinite(losses)), f"train_yi6b: losses {losses}")
    check(losses[-1] < losses[0], f"train_yi6b: loss did not fall {losses}")
    check(all(np.isfinite(r["grad_norm"]) for r in rows),
          "train_yi6b: non-finite grad_norm")
    check(_changed(before, state), "train_yi6b: parameters did not change")
    tail = rows[1:]
    med = {k: float(np.median([r[k] for r in tail]))
           for k in ("step_s", "fwd_bwd_s", "optimizer_s", "host_s")}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_model_flops(cfg)
    share = flops / med["step_s"] / roof.PEAK_FLOPS_BF16
    share_lm = 6 * n_params * tokens / med["step_s"] / roof.PEAK_FLOPS_BF16
    print(f"  train_yi6b: losses {[round(x, 4) for x in losses]}; median of "
          f"steps 2-{TRAIN_STEPS}: {med['step_s']:.4f} s a step "
          f"(forward + backward {med['fwd_bwd_s']:.4f} s, optimizer "
          f"{med['optimizer_s']:.4f} s; host clock {med['host_s']:.4f} s), "
          f"{tokens / med['step_s']:.0f} tokens/s, model FLOP/s "
          f"(roofline.model.model_flops, 6 x {flops / 6 / tokens:.0f} "
          f"params x tokens) = {share:.4f} of the bf16 dense peak "
          f"({roof.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s; the recompute not "
          f"counted); 6 x the LM's {n_params} parameters gives "
          f"{share_lm:.4f}: the reference's count leaves out the "
          f"{n_params - flops / 6 / tokens:.0f} norm scales")
    print(f"  train_yi6b: one more step under torch.profiler: device busy "
          f"{prof['device_ms']:.1f} ms of {prof['wall_ms']:.1f} ms; by op "
          f"(self device ms, calls): " + "; ".join(
              f"{r['op']} {r['device_ms']:.1f} ({r['calls']})"
              for r in prof["top"]))
    path.update({"arch": cfg.name, "layers": TRAIN_LAYERS,
                 "layers_full": full.n_layers, "params": n_params,
                 "params_full": full_params, "profile": prof,
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": rows,
                 "median_step_s": med["step_s"],
                 "median_fwd_bwd_s": med["fwd_bwd_s"],
                 "median_optimizer_s": med["optimizer_s"],
                 "median_host_s": med["host_s"],
                 "tokens_per_s": tokens / med["step_s"],
                 "model_flops": flops, "bf16_peak_share": share,
                 "bf16_peak_share_6_n_lm_params": share_lm,
                 "free_bytes_before": free})
    del state, step
    return _mem_after("train_yi6b", path)


def _train_model_flops(cfg):
    """The reference's MODEL_FLOPS of one training step at B = TRAIN_BATCH,
    S = TRAIN_SEQ (``roofline.model.model_flops``: 6 x its parameter
    count x tokens, the norm scales left out)."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.roofline import model as roof
    return roof.model_flops(cfg, ShapeCfg("train", TRAIN_SEQ, TRAIN_BATCH,
                                          "train"), "train")


def _same_opt_state(a, b):
    """Whether two optimizer states hold bitwise the same master, m and v
    (a sharded one's slices read whole)."""
    import torch
    from repro_torch.train import optimizer as opt
    for name in ("master", "m", "v"):
        for (xs, _), (ys, _) in zip(opt.groups(getattr(a, name)),
                                    opt.groups(getattr(b, name))):
            for x, y in zip(xs, ys, strict=True):
                x = x.local if isinstance(x, opt.Shard) else x
                y = y.local if isinstance(y, opt.Shard) else y
                if not torch.equal(x, y):
                    return False
    return True


def _fsdp_gate(card):
    """(a) one gradient of yi-6b at full width and FSDP_GATE_LAYERS
    layers, applied twice through the unsharded ``apply`` and through the
    sharded one on ``LocalMesh((2, 1), ("data", "model"))``, from two
    states drawn from the same seed: master, m, v, the bf16 weights and
    ``grad_norm`` bitwise equal."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm_synth
    from repro_torch.dist import LocalMesh
    from repro_torch.dist.specs import make_rules
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=FSDP_GATE_LAYERS)
    mesh = LocalMesh((FSDP_WIDTH, 1), ("data", "model"))
    rules = make_rules(mesh, cfg.parallel.layout)
    ocfg = opt.OptCfg(warmup_steps=2)
    a, b = (ts.init_state(cfg, torch.Generator(device="cuda").manual_seed(
        SEED)) for _ in range(2))
    n_params = sum(p.numel() for p in a.params.parameters())
    check(all(torch.equal(x, y) for x, y in
              zip(a.params.parameters(), b.params.parameters())),
          "train_fsdp: two draws from one seed differ")
    b.opt = opt.shard(b.opt, b.params, transformer.param_specs(
        cfg, rules, for_opt=True), mesh, rules.fsdp)
    check(opt.is_sharded(b.opt), "train_fsdp: the state is not sharded")
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=SEED)
    grads, _ = ts.make_train_step(cfg, ocfg).grads(a, lm_synth.batch_at(
        data, 0))
    norms = []
    for _ in range(2):
        _, a.opt, sa = opt.apply(ocfg, a.opt, grads, a.params)
        _, b.opt, sb = opt.apply(ocfg, b.opt, grads, b.params)
        norms.append((float(sa["grad_norm"]), float(sb["grad_norm"])))
        check(torch.equal(sa["grad_norm"], sb["grad_norm"]),
              f"train_fsdp: grad_norm {norms[-1]}")
    check(all(torch.equal(x, y) for x, y in
              zip(a.params.parameters(), b.params.parameters())),
          "train_fsdp: bf16 weights differ")
    check(_same_opt_state(a.opt, b.opt), "train_fsdp: master/m/v differ")
    print(f"  train_fsdp (a): {cfg.name} full width, {FSDP_GATE_LAYERS} "
          f"layers, {n_params / 1e9:.3f} B params; one gradient (B = "
          f"{TRAIN_BATCH}, S = {TRAIN_SEQ}) applied twice, unsharded and "
          f"sharded over data = {FSDP_WIDTH}: master, m, v, bf16 weights "
          f"and grad_norm {norms[0][0]:.6g} bitwise equal, on {card}")
    del a, b, grads
    return {"gate_layers": FSDP_GATE_LAYERS, "gate_params": n_params,
            "gate_bitwise": True, "gate_grad_norms": norms}


def _fsdp_per_rank(card):
    """(c) the bytes each rank holds for full-depth yi-6b at each of
    FSDP_WIDTHS: bf16 weights and gradients whole, master, m and v the
    largest slice ``state_specs`` gives a rank (arithmetic, no reading:
    ``launch.dryrun.held_params``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import LocalMesh
    from repro_torch.dist.specs import make_rules
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.train import train_step as ts
    full = get_config(LM_ARCH)
    lm = transformer.LM(full, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    out = {}
    for w in FSDP_WIDTHS:
        mesh = LocalMesh((w, 1), ("data", "model"))
        rules = make_rules(mesh, full.parallel.layout)
        held = dryrun.held_params(lm, ts.state_specs(full, rules).opt.master,
                                  mesh, (rules.fsdp,))
        out[w] = {"bytes": 4 * n + 12 * held, "state_params_held": held}
    # summing one leaf's gradient over the ranks (ShardedTrainStep._sum's
    # reduce-scatter and all-gather) holds three more bf16 copies of it
    transient = 3 * 2 * max(p.numel() for p in lm.parameters())
    print(f"  train_fsdp (c): arithmetic from state_specs, not a reading: "
          f"full-depth {full.name} ({n / 1e9:.2f} B params) holds per rank "
          + ", ".join(f"{v['bytes'] / 1e9:.1f} GB at fsdp {w}"
                      for w, v in out.items())
          + f" (bf16 weights and gradients whole, 4 B a param; float32 "
          f"master, m and v sliced, 12 B a held param; activations not "
          f"counted), plus {transient / 1e9:.2f} GB for a moment above fsdp "
          f"1 (three bf16 copies of the largest leaf while its gradient is "
          f"summed); the card ({card}) has 80 GB")
    return {"per_rank_bytes_by_width": out, "params_full": n,
            "transient_sum_bytes": transient}


def _train_fsdp(yi6b, card):
    """``train_fsdp``: (a) the optimizer's bitwise gate; (b) train_yi6b's
    run through the data-parallel step on ``LocalMesh((2, 1), ("data",
    "model"))``, the batch split over data, the state sharded, each step
    split into forward + backward, the optimizer's slice update and the
    weight gather; (c) the per-rank arithmetic; every line names the
    card."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm_synth
    from repro_torch.dist import LocalMesh
    from repro_torch.dist.specs import make_rules
    from repro_torch.roofline import model as roof
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    free = _mem_before("train_fsdp")
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    mesh = LocalMesh((FSDP_WIDTH, 1), ("data", "model"))
    rules = make_rules(mesh, cfg.parallel.layout, batch_size=TRAIN_BATCH)
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=SEED)

    def run():
        out = _fsdp_gate(card)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = ts.init_state(cfg, torch.Generator(device="cuda").manual_seed(
            SEED))
        step = ts.make_train_step(cfg, opt.OptCfg(warmup_steps=2), mesh,
                                  rules)
        check(isinstance(step, ts.ShardedTrainStep) and rules.dp == ("data",),
              f"train_fsdp: step {type(step).__name__}, dp {rules.dp}")
        step.shard_state(state)
        before = _param_sample(state)
        rows = []
        for i in range(TRAIN_STEPS):
            batch = lm_synth.batch_at(data, i)
            e0, e1, e2, e3 = _events(4)
            e0.record()
            grads, metrics = step.grads(state, batch)
            e1.record()
            state.opt, stats = opt.update_slices(step.opt_cfg, state.opt,
                                                 grads, state.params)
            e2.record()
            opt.write_weights(state.opt, state.params)
            e3.record()
            state.step.add_(1)
            del grads
            e3.synchronize()
            rows.append({"step_s": e0.elapsed_time(e3) / 1e3,
                         "fwd_bwd_s": e0.elapsed_time(e1) / 1e3,
                         "update_s": e1.elapsed_time(e2) / 1e3,
                         "gather_s": e2.elapsed_time(e3) / 1e3,
                         "loss": float(metrics["loss"]),
                         "grad_norm": float(stats["grad_norm"])})
        out["changed"] = _changed(before, state)
        out["sharded"] = opt.is_sharded(state.opt)
        del state, step
        return rows, out

    (rows, out), path = _run_path("train_fsdp", run, {})
    losses = [r["loss"] for r in rows]
    ref_loss = yi6b["steps"][0]["loss"]
    rels = []
    for i, (r, ref) in enumerate(zip(rows, yi6b["steps"], strict=True)):
        tol = FSDP_FIRST_RTOL if i == 0 else FSDP_STEP_RTOL
        for key in ("loss", "grad_norm"):
            rels.append(abs(r[key] - ref[key]) / abs(ref[key]))
            check(rels[-1] <= tol, f"train_fsdp: step {i + 1} {key} "
                  f"{r[key]} against train_yi6b's {ref[key]} (rel "
                  f"{rels[-1]:.3e}, limit {tol})")
    rel = rels[0]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train_fsdp: losses {losses}")
    check(out["changed"] and out["sharded"],
          "train_fsdp: parameters unchanged or state not sharded")
    tail = rows[1:]
    med = {k: float(np.median([r[k] for r in tail]))
           for k in ("step_s", "fwd_bwd_s", "update_s", "gather_s")}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = _train_model_flops(cfg) / med["step_s"] / roof.PEAK_FLOPS_BF16
    peak = torch.cuda.max_memory_allocated()
    print(f"  train_fsdp (b): {cfg.name} full width, {TRAIN_LAYERS} layers, "
          f"B = {TRAIN_BATCH} split over data = {FSDP_WIDTH}, S = "
          f"{TRAIN_SEQ}; losses {[round(x, 4) for x in losses]}, step 1 "
          f"loss within {rel:.2e} of train_yi6b's {ref_loss:.4f} and "
          f"grad_norm within {rels[1]:.2e} (limit {FSDP_FIRST_RTOL}), "
          f"steps 2-{TRAIN_STEPS} loss and grad_norm within "
          f"{max(rels[2:]):.2e} (limit {FSDP_STEP_RTOL}); median of "
          f"steps 2-{TRAIN_STEPS} on {card}: {med['step_s']:.4f} s a step "
          f"(forward + backward {med['fwd_bwd_s']:.4f} s, slice update "
          f"{med['update_s']:.4f} s, weight gather {med['gather_s']:.4f} s), "
          f"{tokens / med['step_s']:.0f} tokens/s, {share:.4f} of the bf16 "
          f"peak (model_flops), peak {peak / 1e9:.2f} GB; train_yi6b: "
          f"{yi6b['median_step_s']:.4f} s (forward + backward "
          f"{yi6b['median_fwd_bwd_s']:.4f} s, optimizer "
          f"{yi6b['median_optimizer_s']:.4f} s), "
          f"{yi6b['tokens_per_s']:.0f} tokens/s, {yi6b['bf16_peak_share']:.4f}"
          f", peak {yi6b['peak_bytes'] / 1e9:.2f} GB")
    out.update(_fsdp_per_rank(card))
    path.update({"card": card, "layers": TRAIN_LAYERS, "batch": TRAIN_BATCH,
                 "seq": TRAIN_SEQ, "fsdp": FSDP_WIDTH, "steps": rows,
                 "first_loss_rel_to_train_yi6b": rel,
                 "loss_grad_norm_rel_to_train_yi6b": rels,
                 "median_step_s": med["step_s"],
                 "median_fwd_bwd_s": med["fwd_bwd_s"],
                 "median_update_s": med["update_s"],
                 "median_gather_s": med["gather_s"],
                 "tokens_per_s": tokens / med["step_s"],
                 "bf16_peak_share": share, "free_bytes_before": free, **out})
    return _mem_after("train_fsdp", path)


def _train_card_vs_cpu():
    """The float32 smoke config's train step, 3 steps from the same state
    (drawn on the CPU, carried to the card through a checkpoint) and
    batches, on the card and on the CPU."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm_synth
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(get_config(LM_ARCH, smoke=True),
                              dtype="float32")
    free = _mem_before("train_card_vs_cpu")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    cpu = ts.init_state(cfg, torch.Generator().manual_seed(SEED))
    ck = Checkpointer(TRAIN_CKPT_DIR)
    ck.save(0, cpu, {"step": 0})
    card, _ = ck.restore(cpu, device="cuda")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=64,
                              global_batch=4, seed=SEED)
    step = ts.make_train_step(cfg)

    def run():
        out = []
        for i in range(3):
            batch = lm_synth.batch_at(data, i)
            _, m_card = step(card, batch)
            _, m_cpu = step(cpu, batch)
            out.append((float(m_card["loss"]), float(m_cpu["loss"])))
        return out

    losses, path = _run_path("train_card_vs_cpu", run, {})
    rel = max(abs(a - b) / abs(b) for a, b in losses)
    p_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(opt.tree_leaves(card.params),
                                 opt.tree_leaves(cpu.params)))
    print(f"  train_card_vs_cpu: losses (card, cpu) {losses}; largest "
          f"relative loss difference {rel:.3e} (limit {CARD_CPU_LOSS_RTOL}), "
          f"largest parameter difference {p_diff:.3e} (limit "
          f"{CARD_CPU_PARAM_ATOL})")
    check(rel <= CARD_CPU_LOSS_RTOL, f"train_card_vs_cpu: losses {losses}")
    check(p_diff <= CARD_CPU_PARAM_ATOL,
          f"train_card_vs_cpu: parameters differ by {p_diff}")
    path.update({"losses": losses, "loss_rel_diff": rel,
                 "param_max_abs_diff": p_diff, "free_bytes_before": free})
    return _mem_after("train_card_vs_cpu", path)


def _train_loop():
    """``repro_torch.launch.train.train`` on the card, smoke config, with a
    failure injected once at step 17: the loop restores step 15's
    checkpoint and finishes."""
    import shutil
    from repro_torch.launch import train as launch_train
    free = _mem_before("train_loop")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    fired = []

    def injector(step):
        if step == 17 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    try:
        (state, report, wall), path = _run_path(
            "train_loop", lambda: launch_train.train(
                LM_ARCH, smoke=True, steps=25, batch=4, seq=32,
                ckpt_dir=TRAIN_CKPT_DIR, ckpt_every=5,
                fault_injector=injector), {})
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    losses = report.losses
    check(report.restarts == 1, f"train_loop: {report.restarts} restarts")
    check(report.final_step == 25, f"train_loop: final step "
          f"{report.final_step}")
    check(losses[-1] < losses[0], f"train_loop: loss did not fall {losses}")
    check(state.step.device.type == "cuda", "train_loop: state not on the card")
    print(f"  train_loop: 25 steps, {report.restarts} restart (injected at "
          f"step 17, resumed from step 15), loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {wall:.3f} s in the loop")
    path.update({"restarts": report.restarts, "final_step": report.final_step,
                 "first_loss": losses[0], "last_loss": losses[-1],
                 "loop_s": wall, "free_bytes_before": free})
    return _mem_after("train_loop", path)


def _train_compressed():
    """``make_train_step_compressed`` on two pods of the card: yi-6b at
    full width, 4 layers, B = 4, S = 512, 4 steps on one batch (as the
    reference's ``tests/test_grad_compress.py``), each split into the
    per-pod gradients, the quantize/reduce and the optimizer."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm_synth
    from repro_torch.dist import LocalMesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    class Wire(LocalMesh):
        """The local mesh, recording the dtype of every sum it makes."""
        payload = []

        def psum(self, x, axis):
            out = super().psum(x, axis)
            self.payload.append((x.dtype, out.dtype))
            return out

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=COMP_LAYERS)
    free = _mem_before("train_compressed")
    data = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=COMP_SEQ,
                              global_batch=COMP_BATCH, seed=SEED)
    ocfg = opt.OptCfg(warmup_steps=2)
    state = ts.init_state(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), compressed=True)
    n_leaves = len(opt.tree_leaves(state.params))
    mesh = Wire((2,), ("pod",))
    step = ts.make_train_step_compressed(cfg, mesh, ocfg)

    batch = lm_synth.batch_at(data, 0)   # one batch, as test_grad_compress

    def run():
        rows = []
        for _ in range(COMP_STEPS):
            e0, e1, e2, e3 = _events(4)
            e0.record()
            pod = step.grads(state, batch)
            e1.record()
            mean, metrics = step.reduce(state, *pod)
            e2.record()
            step.update(state, mean, metrics)
            e3.record()
            del pod, mean
            e3.synchronize()
            rows.append({"step_s": e0.elapsed_time(e3) / 1e3,
                         "pod_grads_s": e0.elapsed_time(e1) / 1e3,
                         "reduce_s": e1.elapsed_time(e2) / 1e3,
                         "optimizer_s": e2.elapsed_time(e3) / 1e3,
                         "loss": float(metrics["loss"])})
        return rows

    rows, path = _run_path("train_compressed", run, {})
    del state, step
    losses = [r["loss"] for r in rows]
    int8 = [p for p in Wire.payload if p[0] == torch.int8]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train_compressed: losses {losses}")
    check(len(int8) == COMP_STEPS * n_leaves and all(
        o == torch.int8 for _, o in int8), f"train_compressed: "
          f"{len(int8)} int8 sums for {COMP_STEPS} x {n_leaves} leaves")
    gc.collect()
    torch.cuda.empty_cache()
    base = ts.init_state(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    _, mb = ts.make_train_step(cfg, ocfg)(base, batch)
    base_loss = float(mb["loss"])
    del base
    rel = abs(base_loss - losses[0]) / losses[0]
    check(rel < 0.02, f"train_compressed: first loss {losses[0]} against "
          f"the baseline step's {base_loss}")
    med = {k: float(np.median([r[k] for r in rows[1:]]))
           for k in ("step_s", "pod_grads_s", "reduce_s", "optimizer_s")}
    print(f"  train_compressed: {cfg.name} full width, {COMP_LAYERS} layers, "
          f"2 pods of B = {COMP_BATCH // 2}, S = {COMP_SEQ}; losses "
          f"{[round(x, 4) for x in losses]}, first within {rel:.2e} of the "
          f"baseline step's {base_loss:.4f}; {len(int8)} int8 sums; median "
          f"of steps 2-{COMP_STEPS}: {med['step_s']:.4f} s a step (per-pod "
          f"gradients {med['pod_grads_s']:.4f} s, quantize/reduce "
          f"{med['reduce_s']:.4f} s, optimizer {med['optimizer_s']:.4f} s)")
    path.update({"layers": COMP_LAYERS, "batch": COMP_BATCH, "seq": COMP_SEQ,
                 "steps": rows, "baseline_first_loss": base_loss,
                 "first_loss_rel_to_baseline": rel,
                 "int8_sums": len(int8), "median_step_s": med["step_s"],
                 "median_pod_grads_s": med["pod_grads_s"],
                 "median_reduce_s": med["reduce_s"],
                 "median_optimizer_s": med["optimizer_s"],
                 "free_bytes_before": free})
    return _mem_after("train_compressed", path)


def _stacked(tree):
    """A reference tree of blocks with each layer stack as one (L, ...)
    tensor on the card."""
    import torch
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return torch.stack(tree.parts)


def _namespace(tree):
    """A nested dict of tensors as attribute-access objects, the shape
    ``transformer._block_apply`` (which returns the block's output and
    its aux loss) reads a block's parameters in."""
    import types
    if isinstance(tree, dict):
        return types.SimpleNamespace(**{k: _namespace(v)
                                        for k, v in tree.items()})
    return tree


def _pipeline_fwd():
    """``make_pp_forward`` over yi-6b's full-width blocks (8 layers, 2
    stages, 4 microbatches of 1 x 1,024 tokens) on two pods of the card,
    against the 8 blocks applied in order."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import LocalMesh
    from repro_torch.dist.pipeline import bubble_fraction, make_pp_forward
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=PP_LAYERS)
    free = _mem_before("pipeline_fwd")
    lm = transformer.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(SEED))
    params = _stacked(lm.reference_tree()["blocks"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn((PP_MICRO, 1, PP_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    positions = torch.arange(PP_SEQ, device="cuda").expand(1, PP_SEQ)

    def block(lp, h):
        return transformer._block_apply(_namespace(lp), h, cfg,
                                        positions)[0]

    fwd = make_pp_forward(block, PP_LAYERS, PP_STAGES, PP_MICRO,
                          LocalMesh((PP_STAGES,), ("pod",)),
                          (None, None, None, None))
    with torch.inference_mode():
        out, path = _run_path("pipeline_fwd", lambda: fwd(params, x), {})
        want = x
        for blk in lm.blocks:           # the LM's own blocks, in order
            want = torch.stack([transformer._block_apply(
                blk, want[m], cfg, positions)[0] for m in range(PP_MICRO)])
    del lm, params
    got = out[(PP_STAGES - 1) * PP_MICRO:].float()
    want = want.float()
    check(out.shape == (PP_STAGES * PP_MICRO, *x.shape[1:]),
          f"pipeline_fwd: output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(got).all()), "pipeline_fwd: non-finite")
    rel = float((got - want).norm() / want.norm())
    check(rel <= LM_LOGIT_REL_L2, f"pipeline_fwd: relative L2 {rel:.3e} "
          f"against the blocks in order")
    bubble = bubble_fraction(PP_STAGES, PP_MICRO)
    print(f"  pipeline_fwd: {PP_LAYERS} full-width blocks, {PP_STAGES} "
          f"stages x {PP_MICRO} microbatches of 1 x {PP_SEQ}; against the "
          f"blocks in order: relative L2 {rel:.3e} (limit {LM_LOGIT_REL_L2}),"
          f" max |diff| {float((got - want).abs().max()):.4f}; "
          f"{path['seconds']:.4f} s, bubble_fraction {bubble}")
    path.update({"layers": PP_LAYERS, "stages": PP_STAGES,
                 "micro": PP_MICRO, "seq": PP_SEQ, "rel_l2": rel,
                 "bubble_fraction": bubble, "free_bytes_before": free})
    return _mem_after("pipeline_fwd", path)


def phase_train(card=None):
    """Phase 4c: the training paths, after phase 4b's weights are gone."""
    paths = {"train_yi6b": _train_yi6b()}
    paths["train_fsdp"] = _train_fsdp(paths["train_yi6b"], card or _card())
    paths["train_card_vs_cpu"] = _train_card_vs_cpu()
    paths["train_loop"] = _train_loop()
    paths["train_compressed"] = _train_compressed()
    paths["pipeline_fwd"] = _pipeline_fwd()
    return paths


# ---------------------------------------------------------------------------
# phase 4d: the other model families at full width
# ---------------------------------------------------------------------------

def _draw(cfg):
    """(weights of ``cfg`` drawn on the card from SEED, init seconds,
    parameter count)."""
    import torch
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0,
            sum(p.numel() for p in params.parameters()))


def _tokens(cfg, b, s, seed):
    import torch
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s))).cuda()


def _prefix(cfg, n, seed):
    """(1, n, 1024) stub frontend embeddings drawn on the card."""
    import torch
    from repro_torch.models import transformer
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((1, n, transformer.STUB_FRONTEND_DIM), generator=gen,
                       device="cuda")


def _flash(cfg):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, attn_impl="flash"))


def _timed(fn):
    """(fn(), seconds to the card's completion)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _moe_flop(cfg, tokens):
    """MoE FFN FLOP of one forward over ``tokens`` tokens, all layers:
    (dense oracle: every token through every routed expert, EP: through
    its top-k), each with the shared experts."""
    m = cfg.moe
    per_expert = 2 * cfg.d_model * 3 * m.d_ff_expert   # gate+up, down
    shared = per_expert * m.n_shared
    n = tokens * cfg.n_layers
    return (n * (per_expert * m.n_experts + shared),
            n * (per_expert * m.top_k + shared))


def _layer0_groups(params, cfg, tokens):
    """Layer 0's expert-group sizes, (min, max) assignments over the
    routed experts, and its MoE input."""
    import torch
    from repro_torch.models import layers, mla, moe, transformer
    blk = params.blocks[0]
    with torch.no_grad():
        x = params.embed[tokens].to(transformer.model_dtype(cfg))
        pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
        x = x + mla.full_attention(blk.attn, layers.rmsnorm(
            blk.norm1, x, cfg.norm_eps), cfg, pos)
        h2 = layers.rmsnorm(blk.norm2, x, cfg.norm_eps)
        _, experts, _ = moe._route(blk.moe.router, h2.reshape(
            -1, cfg.d_model), cfg.moe.top_k)
        sizes = torch.bincount(experts.reshape(-1),
                               minlength=cfg.moe.n_experts)
    return int(sizes.min()), int(sizes.max()), h2


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _layer_walk(params, cfg_a, cfg_b, tokens, embeds=None, mesh_a=None,
                mesh_b=None):
    """Two forwards of the same weights, ``a`` and ``b`` (``"attn"``
    blocks), walked layer by layer side by side.  Per layer: the
    teacher-forced difference, block ``a``'s and block ``b``'s residual
    delta (attention, then the FFN) on ``a``'s own input, as a relative
    L2 (``layer_rel_l2``; ``attn_rel_l2`` the attention's alone); for MoE
    the share of tokens whose top-k expert set differs between the two
    streams (``route_flips``); and how far the two residual streams have
    drifted apart (``stream_rel_l2``)."""
    import torch
    from repro_torch.models import attention, layers, mla, moe, transformer
    same_attn = cfg_a.parallel.attn_impl == cfg_b.parallel.attn_impl
    eps = cfg_a.norm_eps

    def attn(blk, cfg, h):
        if cfg.mla is not None:
            return mla.full_attention(blk.attn, h, cfg, pos)
        return attention.full_attention(blk.attn, h, cfg, pos)

    def ffn(blk, cfg, mesh, h2):
        if cfg.moe is not None:
            return moe.moe_block(blk.moe, h2, cfg, mesh)[0]
        return layers.mlp(blk.mlp, h2)

    def expert_sets(blk, h2):
        e = moe._route(blk.moe.router, h2.reshape(-1, cfg_a.d_model),
                       cfg_a.moe.top_k)[1]
        return e.sort(dim=-1).values

    rows = []
    with torch.no_grad():
        x_a = transformer._embed_inputs(params, cfg_a, tokens, embeds)
        x_b = x_a.clone()
        pos = torch.arange(x_a.shape[1], device=x_a.device).expand(
            x_a.shape[:2])
        for blk in params.blocks:
            a_a = attn(blk, cfg_a, layers.rmsnorm(blk.norm1, x_a, eps))
            a_t = a_a if same_attn else attn(
                blk, cfg_b, layers.rmsnorm(blk.norm1, x_a, eps))
            a_b = attn(blk, cfg_b, layers.rmsnorm(blk.norm1, x_b, eps))
            h2_a, h2_t, h2_b = (layers.rmsnorm(blk.norm2, y, eps) for y in
                                (x_a + a_a, x_a + a_t, x_b + a_b))
            f_a = ffn(blk, cfg_a, mesh_a, h2_a)
            f_t = ffn(blk, cfg_b, mesh_b, h2_t)
            f_b = ffn(blk, cfg_b, mesh_b, h2_b)
            row = {"layer_rel_l2": _rel(a_a + f_a, a_t + f_t),
                   "attn_rel_l2": _rel(a_a, a_t)}
            if cfg_a.moe is not None:
                row["route_flips"] = float(
                    (expert_sets(blk, h2_a) != expert_sets(blk, h2_b))
                    .any(dim=-1).double().mean())
            x_a, x_b = x_a + a_a + f_a, x_b + a_b + f_b
            row["stream_rel_l2"] = _rel(x_a, x_b)
            rows.append(row)
    return rows


def _walk_summary(rows):
    """The largest per-layer readings of :func:`_layer_walk`, and the
    route flips and stream drift at the first, middle and last layers."""
    out = {k: max(r[k] for r in rows) for k in rows[0]
           if k in ("layer_rel_l2", "attn_rel_l2")}
    picks = sorted({0, len(rows) // 2, len(rows) - 1})
    for k in ("route_flips", "stream_rel_l2"):
        if k in rows[0]:
            out[k] = {i: rows[i][k] for i in picks}
    return out


def _moe_mla_prefill():
    """deepseek-v2-lite-16b at full width and depth, B = 1, S = 4,096:
    the forward through EP on a one-bank mesh against the dense oracle on
    the same weights."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import LocalMesh
    from repro_torch.models import moe, transformer
    cfg = get_config(MOE_ARCH)
    free = _mem_before("moe_mla_prefill")
    params, init_s, n_params = _draw(cfg)
    tokens = _tokens(cfg, 1, MLA_SEQ, SEED + 21)
    mesh = LocalMesh((1,), ("model",))
    with torch.no_grad():
        (logits, aux), path = _run_path(
            "moe_mla_prefill",
            lambda: transformer.forward(params, cfg, tokens, None, mesh), {})
        (want, want_aux), dense_s = _timed(
            lambda: transformer.forward(params, cfg, tokens))
        # again, warm: the first call meets every expert group's product
        # shape for the first time
        _, warm_s = _timed(lambda: transformer.forward(params, cfg, tokens,
                                                       None, mesh))
    check(logits.shape == (1, MLA_SEQ, cfg.vocab_padded),
          f"moe_mla_prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux)),
          "moe_mla_prefill: non-finite logits or aux")
    gate = _lm_readings(logits, want, tokens)
    del logits, want
    gmin, gmax, h2 = _layer0_groups(params, cfg, tokens)
    blk = params.blocks[0].moe
    with torch.no_grad():
        moe.moe_ep(blk, h2, cfg, mesh)                     # warm
        prof_ep = _profiled(lambda: moe.moe_ep(blk, h2, cfg, mesh), top=8)
        prof_dense = _profiled(lambda: moe.moe_dense(blk, h2, cfg), top=4)
    del h2
    walk = _layer_walk(params, cfg, cfg, tokens, mesh_a=mesh)
    summary = _walk_summary(walk)
    flop_dense, flop_ep = _moe_flop(cfg, MLA_SEQ)
    print(f"  moe_mla_prefill: {cfg.name} {cfg.n_layers} layers, d "
          f"{cfg.d_model}, MLA rank {cfg.mla.kv_lora_rank}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.n_shared} shared; {n_params / 1e9:.3f} B params (init "
          f"{init_s:.2f} s); EP forward {path['seconds']:.3f} s (warm "
          f"{warm_s:.3f} s), dense oracle {dense_s:.3f} s (MoE FFN {flop_ep / 1e12:.1f} against "
          f"{flop_dense / 1e12:.1f} TFLOP); aux {float(aux):.4f} (dense "
          f"{float(want_aux):.4f}); end to end against the dense oracle: "
          f"argmax agreement {gate['argmax_agreement']:.4f}, relative L2 "
          f"without the input token's column {gate['logit_rel_l2']:.3e}; "
          f"layer by layer on the EP forward's own inputs: largest MoE "
          f"block difference EP vs dense {summary['layer_rel_l2']:.3e} "
          f"(limit {MOE_LAYER_REL_L2}), routes differing between the two "
          f"forwards at layers {summary['route_flips']}, streams apart by "
          f"{summary['stream_rel_l2']}; layer 0: expert groups "
          f"{gmin}-{gmax} of {MLA_SEQ * cfg.moe.top_k} assignments; its MoE "
          f"under torch.profiler: EP {prof_ep['wall_ms']:.2f} ms wall, "
          f"device busy {prof_ep['device_ms']:.2f} ms, by op: " + "; ".join(
              f"{r['op']} {r['device_ms']:.2f} ({r['calls']})"
              for r in prof_ep["top"]) + f"; dense "
          f"{prof_dense['wall_ms']:.2f} ms wall, device busy "
          f"{prof_dense['device_ms']:.2f} ms")
    # the two forwards' routes flip apart (printed above): end to end only
    # the argmax is held
    _lm_gate(gate, "moe_mla_prefill", "the dense oracle", rel_l2=False)
    check(summary["layer_rel_l2"] <= MOE_LAYER_REL_L2, "moe_mla_prefill: "
          f"an MoE block differs from the dense oracle on the same input "
          f"by a relative L2 of {summary['layer_rel_l2']:.3e}")
    path.update({"arch": cfg.name, "params": n_params, "seq": MLA_SEQ,
                 "init_s": init_s, **gate, "dense_forward_s": dense_s,
                 "ep_forward_warm_s": warm_s,
                 "aux": float(aux), "dense_aux": float(want_aux),
                 "moe_tflop_ep": flop_ep / 1e12,
                 "moe_tflop_dense": flop_dense / 1e12,
                 "layer0_group_min": gmin, "layer0_group_max": gmax,
                 "layer0_ep_profile": prof_ep,
                 "layer0_dense_profile": prof_dense,
                 "walk": walk, "free_bytes_before": free})
    del params
    return _mem_after("moe_mla_prefill", path)


def _moe_mla_serve():
    """The serving driver on deepseek-v2-lite-16b at full width: decode on
    the absorbed MLA cache through EP, the AM cache in front."""
    from repro_torch.models import mla
    free = _mem_before("moe_mla_serve")
    out, launches, seconds, groups = _serve_path(
        "moe_mla_serve", ["--arch", MOE_ARCH, "--full"])
    eng = out["engine"]
    cfg = eng.cfg
    checks = _engine_against_forward(out, path="moe_mla_serve",
                                     elementwise=False)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in eng.cache.values())
    per_token = cache_bytes / (eng.batch * eng.max_len)
    c_shp, r_shp = mla.cache_shape(cfg, 1, 1)
    m = cfg.mla
    kv_heads = (cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
                + cfg.n_heads * m.v_head_dim)
    materialised = kv_heads * 2 * cfg.n_layers
    check(per_token == (c_shp[-1] + r_shp[-1]) * 2 * cfg.n_layers,
          f"moe_mla_serve: {per_token} cache bytes a token")
    ms = [c["engine_ms_per_step"] for c in checks]
    print(f"  moe_mla_serve: launches {launches}, {seconds:.3f} s; 6/6 "
          f"answered, {len(out['generated'])} generated in {out['ticks']} "
          f"ticks, cache {out['cache']['hits']}/{out['cache']['lookups']} "
          f"hits; latent cache {per_token:.0f} B a token ({cfg.n_layers} "
          f"layers x (c_kv {c_shp[-1]} + k_rope {r_shp[-1]}) x 2 B; the "
          f"same heads as a materialised K/V cache: {materialised} B); "
          f"engine vs forward {json.dumps(checks)}")
    path = {"launches": launches, "seconds": seconds, "groups": groups,
            "answered": len(out["results"]),
            "generated": len(out["generated"]), "ticks": out["ticks"],
            "hits": out["cache"]["hits"], "lookups": out["cache"]["lookups"],
            "cache_bytes_per_token": per_token,
            "materialised_bytes_per_token": materialised,
            "engine_ms_per_step": ms, "engine_vs_forward": checks,
            "free_bytes_before": free}
    del out, eng
    return _mem_after("moe_mla_serve", path)


def _flash_against_einsum(path, cfg, params, tokens, embeds=None, mesh=None):
    """The flash forward (one launch a layer) against the einsum forward on
    the same weights, held on the token positions by the gates of
    ``lm_prefill``.  Returns the path's reading."""
    import torch
    from repro_torch.models import transformer
    flash = _flash(cfg)
    with torch.no_grad():
        (got, _), reading = _run_path(
            path, lambda: transformer.forward(params, flash, tokens, embeds,
                                              mesh),
            {"flash_attention": cfg.n_layers})
        want, einsum_s = _timed(lambda: transformer.forward(
            params, cfg, tokens, embeds, mesh)[0])
    p = 0 if embeds is None else embeds.shape[1]
    check(got.shape == (*tokens.shape[:1], p + tokens.shape[1],
                        cfg.vocab_padded), f"{path}: logits shape "
          f"{tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{path}: non-finite logits")
    gate = _lm_readings(got[:, p:], want[:, p:], tokens)
    del got, want
    walk = _layer_walk(params, flash, cfg, tokens, embeds, mesh, mesh)
    summary = _walk_summary(walk)
    print(f"  {path}: flash against einsum layer by layer on the flash "
          f"forward's own inputs: largest attention difference "
          f"{summary['attn_rel_l2']:.3e} (limit {FLASH_LAYER_REL_L2}), "
          f"block {summary['layer_rel_l2']:.3e}; streams apart by "
          f"{summary['stream_rel_l2']}"
          + (f", routes differing at layers {summary['route_flips']}"
             if "route_flips" in summary else ""))
    check(summary["attn_rel_l2"] <= FLASH_LAYER_REL_L2, f"{path}: flash "
          f"attention differs from einsum on the same input by a relative "
          f"L2 of {summary['attn_rel_l2']:.3e}")
    # an MoE forward's routes flip apart (printed above): end to end only
    # the argmax is held there
    _lm_gate(gate, path, rel_l2=cfg.moe is None)
    reading.update({**gate, "einsum_forward_s": einsum_s, "walk": walk,
                    "prefix": p, "seq": p + tokens.shape[1]})
    return reading


def _vlm_prefill():
    """pixtral-12b at full width and depth on the flash kernel: 256 stub
    patch embeddings and 3,840 tokens, held against the einsum forward on
    the token positions."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(VLM_ARCH)
    free = _mem_before("vlm_prefill")
    params, init_s, n_params = _draw(cfg)
    tokens = _tokens(cfg, 1, VLM_TOKENS, SEED + 22)
    embeds = _prefix(cfg, cfg.n_prefix_embeds, SEED + 23)
    path = _flash_against_einsum("vlm_prefill", cfg, params, tokens, embeds)
    print(f"  vlm_prefill: {cfg.name} {n_params / 1e9:.3f} B params (init "
          f"{init_s:.2f} s), {cfg.n_prefix_embeds} patch embeddings + "
          f"{VLM_TOKENS} tokens; flash {path['seconds']:.3f} s, einsum "
          f"{path['einsum_forward_s']:.3f} s; on the token positions: argmax "
          f"agreement {path['argmax_agreement']:.4f}, relative L2 "
          f"{path['logit_rel_l2']:.3e} (limit {LM_LOGIT_REL_L2})")
    path.update({"arch": cfg.name, "params": n_params, "init_s": init_s,
                 "free_bytes_before": free})
    del params
    return _mem_after("vlm_prefill", path)


def _scan_readings(rec, cfg):
    """The RG-LRU's log-depth scan on one full-width (1, S, R) input: its
    ms (median of 5 CUDA-event timings) and its relative L2 difference
    from the step-by-step recurrence on the card."""
    import torch
    from repro_torch.models import rglru
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    x = torch.randn((1, HYBRID_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        got = rglru.rglru_scan(rec, x)
        times = []
        for _ in range(5):
            e0, e1 = _events(2)
            e0.record()
            rglru.rglru_scan(rec, x)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        h = torch.zeros((1, cfg.d_model), device="cuda")
        steps = []
        for t in range(HYBRID_SEQ):
            out, h = rglru.rglru_step(rec, x[:, t:t + 1], h)
            steps.append(out)
        want = torch.cat(steps, dim=1).float()
    rel = float((got.float() - want).norm() / want.norm())
    return float(np.median(times)), rel


def _hybrid_prefill():
    """recurrentgemma-2b at full width and depth, B = 1, S = 4,096 (two
    2,048-token windows: the chunked local path), then 64 tokens decoded
    by the engine against the forward over them."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    cfg = get_config(HYBRID_ARCH)
    free = _mem_before("hybrid_prefill")
    params, init_s, n_params = _draw(cfg)
    tokens = _tokens(cfg, 1, HYBRID_SEQ, SEED + 25)
    with torch.no_grad():
        (logits, _), path = _run_path(
            "hybrid_prefill", lambda: transformer.forward(params, cfg,
                                                          tokens), {})
    check(logits.shape == (1, HYBRID_SEQ, cfg.vocab_padded),
          f"hybrid_prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "hybrid_prefill: non-finite")
    del logits
    rec = next(b.rec for i, b in enumerate(params.blocks)
               if cfg.block_kind(i) == "rglru")
    scan_ms, scan_rel = _scan_readings(rec, cfg)
    n_scan = sum(cfg.block_kind(i) == "rglru" for i in range(cfg.n_layers))
    print(f"  hybrid_prefill: {cfg.name} {n_params / 1e9:.3f} B params "
          f"(init {init_s:.2f} s), pattern {cfg.block_pattern}, window "
          f"{cfg.local_window}; forward {path['seconds']:.3f} s; RG-LRU scan "
          f"{scan_ms:.3f} ms a layer at (1, {HYBRID_SEQ}, {cfg.d_model}) x "
          f"{n_scan} layers, against the step loop relative L2 "
          f"{scan_rel:.3e} (limit {SCAN_REL_L2})")
    dec = _decode_against_forward("hybrid_prefill", cfg, params,
                                  tokens[0, :HYBRID_DECODE].cpu().numpy(),
                                  elementwise=False)
    check(scan_rel <= SCAN_REL_L2, f"hybrid_prefill: the scan differs from "
          f"the step-by-step recurrence by a relative L2 of {scan_rel:.3e}")
    path.update({"arch": cfg.name, "params": n_params, "init_s": init_s,
                 "seq": HYBRID_SEQ, "rglru_scan_ms": scan_ms,
                 "rglru_layers": n_scan, "scan_vs_steps_rel_l2": scan_rel,
                 "decode_vs_forward": dec, "free_bytes_before": free})
    del params
    return _mem_after("hybrid_prefill", path)


def _xlstm_train():
    """xlstm-125m at full size: the forward at B = 4, S = 2,048; 6 steps
    of ``make_train_step`` on one ``lm_synth`` batch at B = 4, S = 256 (as
    ``train_compressed`` steps on one batch, so the loss must fall; the
    sLSTM's loop over time, forward, recompute and backward, sets the
    length); 32 tokens decoded against the forward."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm_synth
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = get_config(XLSTM_ARCH)
    free = _mem_before("xlstm_train")
    state = ts.init_state(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    n_params = sum(p.numel() for p in state.params.parameters())
    step = ts.make_train_step(cfg, opt.OptCfg(warmup_steps=2))

    def data(seq):
        return lm_synth.batch_at(lm_synth.LMDataCfg(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=XLSTM_BATCH,
            seed=SEED), 0)

    long, batch = data(XLSTM_SEQ), data(XLSTM_TRAIN_SEQ)

    def run():
        with torch.no_grad():
            logits, fwd_s = _timed(lambda: transformer.forward(
                state.params, cfg, long["tokens"])[0])
        finite = bool(torch.isfinite(logits).all())
        del logits
        rows = []
        for _ in range(XLSTM_STEPS):
            e0, e1 = _events(2)
            e0.record()
            _, metrics = step(state, batch)
            e1.record()
            e1.synchronize()
            rows.append({"step_s": e0.elapsed_time(e1) / 1e3,
                         "loss": float(metrics["loss"])})
        return fwd_s, finite, rows

    (fwd_s, finite, rows), path = _run_path("xlstm_train", run, {})
    losses = [r["loss"] for r in rows]
    med = float(np.median([r["step_s"] for r in rows[1:]]))
    tokens = XLSTM_BATCH * XLSTM_TRAIN_SEQ
    print(f"  xlstm_train: {cfg.name} {n_params / 1e9:.4f} B params, "
          f"pattern {cfg.block_pattern}; forward at B = {XLSTM_BATCH}, S = "
          f"{XLSTM_SEQ} {fwd_s:.3f} s; training at B = {XLSTM_BATCH}, S = "
          f"{XLSTM_TRAIN_SEQ}: losses {[round(x, 4) for x in losses]}; "
          f"median of steps 2-{XLSTM_STEPS} {med:.4f} s a step, "
          f"{tokens / med:.0f} tokens/s")
    check(finite, "xlstm_train: non-finite forward logits")
    check(all(np.isfinite(losses)), f"xlstm_train: losses {losses}")
    check(losses[-1] < losses[0], f"xlstm_train: loss did not fall {losses}")
    dec = _decode_against_forward("xlstm_train", cfg, state.params,
                                  long["tokens"][0, :XLSTM_DECODE],
                                  elementwise=False)
    path.update({"arch": cfg.name, "params": n_params,
                 "batch": XLSTM_BATCH, "seq": XLSTM_SEQ,
                 "train_seq": XLSTM_TRAIN_SEQ, "forward_s": fwd_s,
                 "steps": rows, "median_step_s": med,
                 "tokens_per_s": tokens / med, "decode_vs_forward": dec,
                 "free_bytes_before": free})
    del state, step
    return _mem_after("xlstm_train", path)


def _family_sweep(arch, name):
    """``arch`` at full width and depth: the flash forward at S = 1,024
    (a frontend's stub prefix included) against the einsum forward, an
    ``ep`` config's MoE through EP on a one-bank mesh, then 4 engine
    decode steps against the forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import LocalMesh
    cfg = get_config(arch)
    free = _mem_before(name)
    params, init_s, n_params = _draw(cfg)
    mesh = LocalMesh((1,), ("model",)) if cfg.parallel.ep else None
    p = cfg.n_prefix_embeds if cfg.frontend else 0
    tokens = _tokens(cfg, 1, SWEEP_SEQ - p, SEED + 26)
    embeds = _prefix(cfg, p, SEED + 27) if p else None
    path = _flash_against_einsum(name, cfg, params, tokens, embeds, mesh)
    print(f"  {name}: {cfg.name} {n_params / 1e9:.3f} B params (init "
          f"{init_s:.2f} s), {cfg.n_layers} layers, dh {cfg.head_dim}"
          f"{', EP on one bank' if mesh else ''}; S = {path['seq']} ({p} "
          f"prefix); flash {path['seconds']:.3f} s, einsum "
          f"{path['einsum_forward_s']:.3f} s; argmax agreement "
          f"{path['argmax_agreement']:.4f}, relative L2 "
          f"{path['logit_rel_l2']:.3e}")
    dec = _decode_against_forward(name, cfg, params,
                                  tokens[0, :SWEEP_DECODE].cpu().numpy(),
                                  mesh, elementwise=False)
    path.update({"arch": cfg.name, "params": n_params, "init_s": init_s,
                 "decode_vs_forward": dec, "free_bytes_before": free})
    del params
    return _mem_after(name, path)


def phase_families():
    """Phase 4d: the other model families at full width, each path with
    the launch counts zeroed before it and read after."""
    t0 = time.perf_counter()
    paths = {"moe_mla_prefill": _moe_mla_prefill()}
    paths["moe_mla_serve"] = _moe_mla_serve()
    paths["vlm_prefill"] = _vlm_prefill()
    paths["hybrid_prefill"] = _hybrid_prefill()
    paths["xlstm_train"] = _xlstm_train()
    for arch, name in SWEEP:
        paths[name] = _family_sweep(arch, name)
    print(f"  phase 4d: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 4e: the top-k sweep
# ---------------------------------------------------------------------------

def phase_topk():
    """``topk_sweep``: the benchmark's k sweep at Q = TOPK_Q, N = TOPK_N,
    D = WIDTH, 3 bits, k = 8 .. 256, fused held bitwise to dense at every
    k, then its merge sweep over TOPK_BANKS banks at TOPK_MERGE_Q queries,
    k = K, N = TOPK_N, D = WIDTH, every merge bitwise ``am.search``.  Each
    dense call launches ``cam_pack`` + ``cam_search``, each fused call
    ``cam_pack`` + ``cam_search_topk``, and a sharded search one of each
    per bank.  Phase 5 holds both tiers at the k sweep's shapes to the
    plain versions."""
    import torch
    from torch_benchmarks import bench_am_topk as bench
    report = bench.new_report()
    dev = torch.device("cuda")

    def run():
        ks = bench.run_k_sweep(False, report, d=WIDTH, q=TOPK_Q, n=TOPK_N,
                               device=dev, verify=True, iters=TOPK_ITERS)
        merges = bench.run_merge_sweep(False, report, device=dev,
                                       banks_sweep=TOPK_BANKS,
                                       iters=TOPK_ITERS, q=TOPK_MERGE_Q,
                                       k=K, n=TOPK_N, d=WIDTH)
        return ks, merges

    calls = 1 + TOPK_ITERS + 1          # warm-up, timed, the bitwise check

    def expect(out):
        ks, merges = out
        dense = len(ks) * calls
        # the k sweep's fused calls and its am.search at k = 256; the merge
        # sweep's am.search and three merges at each bank count
        fused = dense + 1 + 1 + sum(3 * calls * int(b) for b in merges)
        return {"cam_search": dense, "cam_search_topk": fused,
                "cam_pack": dense + fused}

    (ks, merges), path = _run_path("topk_sweep", run, expect)
    check(sorted(ks) == list(bench.K_SWEEP) and all(
        v["bitwise"] for v in ks.values()), f"topk_sweep: k points {ks}")
    for k, v in ks.items():
        check(v["fused_out_bytes"] == TOPK_Q * k * 8,
              f"topk_sweep: fused output bytes {v['fused_out_bytes']} at "
              f"k={k}")
        print(f"  topk_sweep: Q={TOPK_Q} N={TOPK_N} D={WIDTH} k={k}: dense "
              f"{v['dense_us']:.1f} us, fused {v['fused_us']:.1f} us "
              f"(median of {TOPK_ITERS}); output bytes dense "
              f"{v['dense_out_bytes']} (the (Q, N) matrix and the (Q, k) "
              f"pair), fused {v['fused_out_bytes']}; bitwise equal")
    geo = report["merge_geometry"]
    for b, v in merges.items():
        print(f"  topk_sweep: merges at {b} banks (Q={geo['q']} k={geo['k']} "
              f"N={geo['n']} D={WIDTH}), bitwise am.search: tree "
              f"{v['tree_us']:.1f} "
              f"us, allgather {v['allgather_us']:.1f} us, ring "
              f"{v['ring_us']:.1f} us; traffic per device tree "
              f"{v['tree_bytes']} B, allgather {v['allgather_bytes']} B, "
              f"ring {v['ring_bytes']} B; auto = {v['auto']}")
    path.update({"q": TOPK_Q, "n": TOPK_N, "d": WIDTH, "bits": BITS,
                 "iters": TOPK_ITERS, "ksweep": {str(k): v for k, v in
                                                 ks.items()},
                 "merge": merges, "merge_geometry": geo})
    return {"topk_sweep": path}


# ---------------------------------------------------------------------------
# phase 4f: the dry-run
# ---------------------------------------------------------------------------

def phase_dryrun(lm_paths, train_paths):
    """``dryrun``: ``launch.dryrun.run_cell`` for the yi-6b cells the card
    measures, as one card (mesh (1, 1)): the prefill at B = 1, S = LM_SEQ
    (einsum, and with flash's score bytes dropped) and train_yi6b's step
    (TRAIN_LAYERS layers, B = TRAIN_BATCH, S = TRAIN_SEQ); each t_bound
    printed beside the seconds measured for it."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    full = get_config(LM_ARCH)
    card_mesh = ((1, 1), ("data", "model"))
    prefill = ShapeCfg("prefill_card", LM_SEQ, 1, "prefill")
    train = ShapeCfg("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    train_cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    measured = {
        "prefill_einsum": lm_paths["lm_prefill"]["einsum_forward_s"],
        "prefill_flash": lm_paths["lm_prefill"]["seconds"],
        "train": train_paths["train_yi6b"]["median_step_s"]}

    def run():
        return {
            "prefill_einsum": dryrun.run_cell(LM_ARCH, prefill, False,
                                              force=True, cfg=full,
                                              mesh=card_mesh),
            "prefill_flash": dryrun.run_cell(LM_ARCH, prefill, False,
                                             force=True, tag="flash",
                                             flash_model=True, cfg=full,
                                             mesh=card_mesh),
            "train": dryrun.run_cell(LM_ARCH, train, False, force=True,
                                     cfg=train_cfg, mesh=card_mesh)}

    cells, path = _run_path("dryrun", run, {})
    for name, rec in cells.items():
        check(rec["status"] == "ok", f"dryrun {name}: {rec['status']} "
              f"{rec.get('reason')}")
        rl = rec["roofline"]
        print(f"  dryrun {name}: {rec['arch']} {rec['shape']} on one card: "
              f"t_bound {rl['t_bound_s']:.4f} s ({rl['bottleneck']}; compute "
              f"{rl['t_compute_s']:.4f} s, memory {rl['t_memory_s']:.4f} s), "
              f"{rl['flops_per_device']:.4e} FLOPs, "
              f"{rl['hbm_bytes_per_device']:.4e} bytes, peak temp "
              f"{rec['memory']['temp_bytes'] / 1e9:.2f} GB; measured "
              f"{measured[name]:.4f} s ({measured[name] / rl['t_bound_s']:.2f}"
              f" x t_bound)")
    path["cells"] = {n: {"roofline": r["roofline"], "memory": r["memory"],
                         "measured_s": measured[n]}
                     for n, r in cells.items()}
    return {"dryrun": path}


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
    from repro_torch.roofline import model as roof
    return roof.bound_ms(bytes_moved, ops, roof.PEAK_OPS_INT8)


def _max_diff(got, want):
    """The largest absolute difference of two int32 matrices, row block by
    row block (a (1,024, 2^20) matrix widened whole would take 8 GB)."""
    import torch
    if torch.equal(got, want):
        return 0.0
    return max(float((g.long() - w.long()).abs().max().item())
               for g, w in zip(got.split(64), want.split(64)))


def _time_dense(q8, t8, levels, groups, err, tier=None, l1=False):
    """One shape of the dense kernel: held against plain, then timed
    through its wrapper (the pack launch included), with
    ``torch.cdist(p=0)`` on float copies as the library call.  ``tier``,
    where given, is another call that must return plain's matrix too.
    ``l1``: the symbols are level codes, ``levels = 2^bits``, searched at
    L1 distance (the L1 pack); plain and the library call count on their
    thermometer expansion."""
    import torch
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    pq, pt, width = q8, t8, d
    if l1:
        bits = levels.bit_length() - 1
        pq, pt = (am.thermometer(x, bits).to(torch.int8) for x in (q8, t8))
        width = ref.l1_width(d, bits)
    plain_ms, want = _timed_once(lambda: ref.mismatch_counts(pq, pt))
    got = kernel.cam_search(q8, t8, levels=levels, l1=l1)
    diff = _max_diff(got, want)
    err["cam_search"] = max(err["cam_search"], diff)
    check(diff == 0, f"cam_search differs from plain by {diff} at "
          f"Q={qn} N={n} D={d}")
    del got
    if tier is not None:
        check(torch.equal(tier(), want), f"the dense tier differs from "
              f"plain at Q={qn} N={n} D={d}")
    del want
    ms = _time_ms(lambda: kernel.cam_search(q8, t8, levels=levels, l1=l1),
                  10)
    qf, tf = pq.float(), pt.float()
    del pq, pt
    lib_ms = _time_ms(lambda: torch.cdist(qf, tf, p=0), 5, 1)
    del qf, tf
    t_b, t_o = _bound_parts(qn * d + n * d + qn * n * 4, qn * n * width)
    return {"Q": qn, "N": n, "D": d, "groups": groups, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bytes_ms": t_b, "ops_ms": t_o, "bound_ms": max(t_b, t_o)}


def _time_fused(q8, t8, vr, levels, k, groups, err, tier=None):
    """One shape of the fused kernel: held against plain, then timed
    through its wrapper (the pack launch included).  Its bound counts the
    live rows only, the ones the result depends on.  ``tier``, where
    given, is another call that must return plain's result too."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    plain_ms, want = _timed_once(lambda: ref.topk(q8, t8, k, valid_rows=vr))
    got = kernel.cam_search_topk(q8, t8, vr, levels=levels, k=k)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"cam_search_topk differs from plain at Q={qn} N={n} D={d} k={k}")
    if tier is not None:
        check(all(torch.equal(g, w) for g, w in zip(tier(), want,
                                                    strict=True)),
              f"the fused tier differs from plain at Q={qn} N={n} D={d} "
              f"k={k}")
    del got, want
    ms = _time_ms(lambda: kernel.cam_search_topk(q8, t8, vr, levels=levels,
                                                 k=k), 10)
    live = int(vr.item())
    t_b, t_o = _bound_parts(qn * d + live * d + 4 + qn * k * 8,
                            qn * live * d)
    return {"Q": qn, "N": n, "D": d, "k": k, "groups": groups, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bytes_ms": t_b, "ops_ms": t_o, "bound_ms": max(t_b, t_o)}


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
            "bytes_ms": t_b, "ops_ms": t_o, "bound_ms": max(t_b, t_o)}


def _time_pack_l1(q8, t8, bits, groups):
    """One shape of the L1 pack kernel: held against plain bitwise, with a
    care plane and without, then timed (without, as the L1 paths run it):
    ``ms`` one call through the wrapper, ``device_ms`` the device's time a
    call in a CUDA graph.  Its bound is the bytes it must move: the int8
    codes read once, the two plane words of each 32-symbol group written
    once."""
    import torch
    from repro_torch.kernels.cam_search import kernel, ref
    (qn, d), n = q8.shape, t8.shape[0]
    gen = torch.Generator(device=t8.device).manual_seed(SEED)
    care = (torch.rand(t8.shape, generator=gen, device=t8.device)
            > 0.25).to(torch.int8)
    plain_ms, want = _timed_once(lambda: (ref.pack_planes_l1(q8, bits),
                                          ref.pack_planes_l1(t8, bits)))
    for c, w_c in ((None, None), (care, ref.pack_care_l1(care, bits))):
        got = kernel.pack_l1(q8, t8, bits=bits, care=c)
        check(all(g is None and w is None or torch.equal(g, w)
                  for g, w in zip(got, (*want, w_c), strict=True)),
              f"cam_pack_l1 differs from plain at Q={qn} N={n} D={d} "
              f"bits={bits} care={c is not None}")
    del got, want, care, w_c
    ms = _time_ms(lambda: kernel.pack_l1(q8, t8, bits=bits), 10)
    device_ms = _graph_ms(lambda: kernel.pack_l1(q8, t8, bits=bits), 20)
    width = ref.l1_width(d, bits)
    _, words, gp = ref.plane_layout(width, 2)
    t_b, t_o = _bound_parts((qn + n) * (d + gp * words * 4),
                            (qn + n) * width)
    return {"Q": qn, "N": n, "D": d, "bits": bits, "groups": groups,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "bytes_ms": t_b, "ops_ms": t_o,
            "bound_ms": max(t_b, t_o)}


#: An H100 SM issues 16 popc a cycle, at up to 1.98 GHz: the bound of the
#: fused top-k's few-row pass, one popc a 32-symbol group of each pair.
POPC_PER_CYCLE, SM_HZ = 16, 1.98e9


def _time_topk_few():
    """The fused top-k at the HDC cell's shape (4,096 queries against 26
    class rows of 4,096 3-bit codes, at L1), which takes the few-row
    partial pass: held bitwise against plain (on the thermometer
    expansion), then timed.  ``ms`` one call through the wrapper;
    ``device_ms`` the device's time a call in a CUDA graph (the L1 pack,
    the partial pass and the merge), ``pack_device_ms`` the L1 pack's
    alone, ``search_device_ms`` the difference (partial and merge passes).
    ``popc_bound_ms``: Q x N x groups popc at ``POPC_PER_CYCLE`` an SM a
    cycle on every SM at ``SM_HZ``."""
    import torch
    from repro_torch.core import am
    from repro_torch.kernels.cam_search import kernel, ref
    dev = torch.device("cuda")
    qn, n, d, levels = 4096, 26, 4096, 1 << BITS
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    q8, t8 = (torch.randint(0, levels, shape, generator=gen, device=dev,
                            dtype=torch.int8) for shape in ((qn, d), (n, d)))
    q8[:n] = t8                                       # an exact hit each
    vr = torch.full((1,), n, dtype=torch.int32, device=dev)

    def call():
        return kernel.cam_search_topk(q8, t8, vr, levels=levels, k=1, l1=True)

    def pack():
        return kernel.pack_l1(q8, t8, bits=BITS)

    pq, pt = (am.thermometer(x, BITS).to(torch.int8) for x in (q8, t8))
    plain_ms, want = _timed_once(lambda: ref.topk(pq, pt, 1, valid_rows=vr))
    del pq, pt
    kernel.reset_launches()
    got = call()
    check(kernel.launches["cam_search_topk_few"] == 1,
          f"the HDC shape took no few-row pass: {dict(kernel.launches)}")
    check(all(torch.equal(g, w) for g, w in zip(got, want, strict=True)),
          "cam_search_topk's few-row pass differs from plain at the HDC "
          "shape")
    del got, want
    ms = _time_ms(call, 10)
    device_ms = _graph_ms(call, 20)
    pack_ms = _graph_ms(pack, 20)
    _, _, gp = ref.plane_layout(ref.l1_width(d, BITS), 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    popc_ms = qn * n * gp / (POPC_PER_CYCLE * sms * SM_HZ) * 1e3
    t_b, t_o = _bound_parts(qn * d + n * d + 4 + qn * 8,
                            qn * n * ref.l1_width(d, BITS))
    return {"Q": qn, "N": n, "D": d, "k": 1, "bits": BITS, "groups": 0,
            "path": "hdc_isolet_d4096.bulk_k1", "ms": ms,
            "device_ms": device_ms, "pack_device_ms": pack_ms,
            "search_device_ms": device_ms - pack_ms,
            "popc_bound_ms": popc_ms, "plain_ms": plain_ms,
            "library_ms": None, "bytes_ms": t_b, "ops_ms": t_o,
            "bound_ms": max(t_b, t_o)}


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
            "launches": sum(p["launches"].get(name, 0)
                            for p in paths.values()),
            "max_abs_err": err[name], "ms": mean("ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": (None if main[0]["library_ms"] is None
                           else mean("library_ms")),
            "timed_path": path,
            "launches_by_path": {p: v["launches"].get(name, 0)
                                 for p, v in paths.items()},
            **{k: mean(k) for k in keys}, "shapes": shapes}


def _topk_sweep_shapes(fused, dense, packs, err):
    """The CAM kernels at ``topk_sweep``'s shapes (Q = TOPK_Q against its
    TOPK_N-row table, the benchmark's own inputs), each held to its plain
    version on the card and timed, appended to the shape lists as a path
    of their own (groups 0: outside the main path's means).  The
    benchmark's fused tier at each k and its dense tier's matrix are held
    to the same plain results."""
    import torch
    from torch_benchmarks import bench_am_topk as bench
    from repro_torch.kernels.cam_search import ops as cam_ops
    levels = 1 << BITS
    queries, table = bench.sweep_inputs(TOPK_Q, TOPK_N, WIDTH, "cuda")
    q8, t8 = queries.to(torch.int8), table.to(torch.int8)
    vr = torch.full((1,), TOPK_N, dtype=torch.int32, device=t8.device)
    tag = {"path": "topk_sweep"}
    for k in bench.K_SWEEP:
        fused.append({**_time_fused(q8, t8, vr, levels, k, 0, err,
                                    tier=lambda k=k: bench.fused_topk(
                                        queries, table, k)), **tag})
    dense.append({**_time_dense(q8, t8, levels, 0, err,
                                tier=lambda: cam_ops.mismatch_counts(
                                    queries, table, BITS)), **tag})
    packs.append({**_time_pack(q8, t8, levels, 0), **tag})


def phase_timing(run, err):
    import torch
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

    # the L1 paths' table and queries, as int8 level codes; their queries
    # padded to each bucket as the service pads them
    l1_codes = svc._tables["l1"].table.codes                # (65536, 256)
    l1_t8 = l1_codes.to(torch.int8)
    l1_q = torch.from_numpy(run["l1_queries"]).to(dev).to(torch.int8)

    def l1_batch(qb, rows):
        q8 = torch.zeros((qb, l1_q.shape[1]), dtype=torch.int8, device=dev)
        q8[:min(qb, rows)] = l1_q[:min(qb, rows)]
        return q8

    # L1 pack kernel, at each bucket size the L1 paths dispatched, then at
    # the HDC cell's batch (4,096 queries and 26 class rows of D = 4,096
    # 3-bit codes; codes drawn uniformly)
    l1_packs = [{**_time_pack_l1(l1_batch(qb, rows), l1_t8, BITS, n),
                 "path": path}
                for path, rows in (("l1_k10", len(l1_q)), ("l1_k300", 4))
                for qb, n in paths[path]["buckets"].items()]
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    hdc_q, hdc_t = (torch.randint(0, 1 << BITS, shape, generator=gen,
                                  device=dev, dtype=torch.int8)
                    for shape in ((4096, 4096), (26, 4096)))
    l1_packs.append({**_time_pack_l1(hdc_q, hdc_t, BITS, 0),
                     "path": "hdc_isolet_d4096.bulk_k1"})
    del hdc_q, hdc_t

    # dense kernel: the L1 k = 300 path (its four queries), then the
    # responses table at Q = 64
    dense = []
    for qb, n in paths["l1_k300"]["buckets"].items():
        q8 = l1_batch(qb, 4)
        shape = _time_dense(q8, l1_t8, levels, n, err, l1=True)
        if qb <= 16:
            shape.update(_tile_ms(lambda: kernel.cam_search(
                q8, l1_t8, levels=levels, l1=True)))
        dense.append(shape)
    del l1_t8
    dense.append(_time_dense(batch(64), t8, levels, 0, err))
    _topk_sweep_shapes(fused, dense, packs, err)
    few = _time_topk_few()
    fused.append(few)
    print(f"  cam_search_topk few-row pass at the HDC shape: device "
          f"{few['device_ms']:.4f} ms a call in a graph (L1 pack "
          f"{few['pack_device_ms']:.4f}, partial + merge "
          f"{few['search_device_ms']:.4f}), one call {few['ms']:.4f} ms; "
          f"popc bound {few['popc_bound_ms']:.4f} ms")

    rows = [
        _row("cam_search", "src/repro/kernels/cam_search/kernel.py:114",
             "l1_k300", paths, dense, err),
        _row("cam_search_topk", "src/repro/kernels/cam_search/kernel.py:402",
             "responses_k10", paths, fused, err),
        _row("cam_pack", "src/repro/kernels/cam_search/kernel.py:59",
             "responses_k10", paths, packs, err),
        _row("cam_pack_l1", "src/repro/core/am.py:515 (plain JAX)",
             "l1_k10", paths, l1_packs, err, keys=("device_ms",)),
    ]
    for r in rows:
        for s in r["shapes"]:
            tiles = "".join(f" {key}={s[key]:.4f}" for key in s
                            if key.startswith("ms_tile")
                            or key == "device_ms")
            extra = "".join(f" {key}={s[key]}" for key in ("k", "bits",
                                                           "path")
                            if key in s)
            print(f"  {r['name']}: Q={s['Q']} N={s['N']} D={s['D']}{extra} "
                  f"groups={s['groups']} ms={s['ms']:.4f} "
                  f"bound_ms={s['bound_ms']:.4f} "
                  f"plain_ms={s['plain_ms']:.2f}{tiles}")
    kernel_ms = sum(s["ms"] * s["groups"] for s in fused)
    print(f"  int32->int8 table cast {cast_ms:.4f} ms per call; "
          f"fused kernel time of the main path {kernel_ms:.2f} ms")
    return rows, {"table_cast_ms": cast_ms, "main_path_kernel_ms": kernel_ms}


def _fp32_bound(bytes_moved, ops):
    """(ms at the memory rate, ms at the float32 CUDA-core rate)."""
    from repro_torch.roofline import model as roof
    return roof.bound_ms(bytes_moved, ops, roof.PEAK_FLOPS_FP32)


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
    from repro_torch.roofline import model as roof
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
    t_b, t_o = roof.bound_ms(bytes_moved, 3 * 2 * b * n * d,
                             roof.PEAK_FLOPS_TF32)
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
    from repro_torch.roofline import model as roof
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
    t_b, t_o = roof.bound_ms(2 * (2 * b * h * s * dh + 2 * b * hk * s * dh),
                             2 * b * h * s * s * dh, roof.PEAK_FLOPS_BF16)
    return {"B": b, "S": s, "H": h, "HK": hk, "dh": dh, "dtype": "bfloat16",
            "causal": True, "groups": launches, "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes_ms": t_b, "ops_ms": t_o}


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
        print("phase 3b: TCAM routing and the exact index")
        tcam_paths = phase_tcam_ivf()
        print("phase 3c: multi-bank sharding and the paper's Fig. 12")
        tcam_paths.update(phase_sharded(run))
        print("phase 3d: durability at full size")
        tcam_paths.update(phase_durable(run, card))
        print("phase 4: the HDC application and the device model")
        app_paths, encode_shapes = phase_app()
        print("phase 4b: the dense LM at full width")
        lm_paths = phase_lm()
        print("phase 4c: training")
        train_paths = phase_train(card)
        print("phase 4d: the other model families at full width")
        family_paths = phase_families()
        print("phase 4e: the top-k sweep")
        topk_paths = phase_topk()
        print("phase 4f: the dry-run")
        dryrun_paths = phase_dryrun(lm_paths, train_paths)
        paths = {**run["paths"], **tcam_paths, **app_paths, **lm_paths,
                 **train_paths, **family_paths, **topk_paths, **dryrun_paths}
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
