#!/usr/bin/env python3
"""Time build-time variants of the port's redesigned kernels on one
NVIDIA GPU, at the shapes of their main paths.

    python3 scripts/kernel_variants.py [--out chiprun_out/kernel_variants.json]
                                       [--only enc_,mc_]

Each variant is a copy of a source under ``src/repro_torch/csrc/`` with
text substitutions, built under ``build/repro_torch/variants/`` (the
sources of the repo are not touched) and swapped in as the library the
wrapper loads.  Variants run in turns, the shipped one first and last.

- ``flash_attention`` (bf16, B = 1, S = 4,096, H = 32, HK = 4, dh = 128,
  causal): other tile shapes at dh = 128 (m tiles per warp, keys per tile,
  Q in registers or shared memory, blocks per SM).  Each is held to
  ``chip_smoke.py``'s kernel gate first.
- ``cam_search_topk`` (Q = 1,024, N = 2^20, D = 256, 3 bits, k = 10):
  ablations that give wrong results and show where the time goes: the
  popcount replaced by one bit of the mask (``no_popc``), the top-k scan
  skipped (``no_scan``), and the compare skipped (``no_compare``).
- ``hdc_encode`` (the four shapes of the ``hdc_encode`` path, on the
  Table III stand-ins' training features): ``tf32x1`` drops the two
  correction products of the 3xTF32 split (a plain TF32 product);
  ``cvt`` rounds to TF32 with ``cvt.rna.tf32.f32`` instead of two integer
  operations; ``bk16_4stage`` and ``bk32_2stage`` change the ring
  (shipped: 16-deep tiles, 3 stages).  Each is held to the reference
  tolerance and to ``ENCODE_FP32_FRACTION`` at every shape; every run of
  the shipped kernel must pass and every run of ``tf32x1`` fail, or the
  script exits 1.
- ``mibo_mc`` (2^20 x 64 and the ``fig9_mc`` shape, 2,048 x 32): rows a
  thread loads before its
  arithmetic (1, 4; shipped 2), the IEEE division by ``ss`` (``div``)
  against the shipped multiplication by its hoisted reciprocal, and the
  grid capped at 8 blocks per SM (``cap8``).  Each is held to rtol 1e-5,
  atol 1e-12 against plain at both shapes.

``hdc_encode`` and ``mibo_mc`` are timed per call (``ms``, as
``chip_smoke.py`` times them) and as device time from a CUDA graph of
launches (``device_ms``).  Prints one line per run and writes the
readings, with the card's name and power limit, to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

_TILE = """  static constexpr int MT = 1;
  static constexpr int BK = 64;
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr int MIN_BLOCKS = HD <= 128 ? 3 : 1;
"""


def _tile(mt, bk, q_regs, blocks):
    return [(_TILE, f"""  static constexpr int MT = HD == 128 ? {mt} : 1;
  static constexpr int BK = HD == 128 ? {bk} : 64;
  static constexpr bool Q_IN_REGS = HD == 128 ? {q_regs} : HD <= 128;
  static constexpr int MIN_BLOCKS = HD == 128 ? {blocks} : HD <= 128 ? 3 : 1;
""")]


#: name -> (source, substitutions); the shipped kernel has none.
VARIANTS = {
    "flash_shipped": ("flash_attention", []),
    "flash_mt1_bk32_qsmem_4blk": ("flash_attention",
                                  _tile(1, 32, "false", 4)),
    "flash_mt1_bk32_qregs_3blk": ("flash_attention", _tile(1, 32, "true", 3)),
    "flash_mt1_bk64_qsmem_3blk": ("flash_attention",
                                  _tile(1, 64, "false", 3)),
    "flash_mt2_bk64_qsmem_2blk": ("flash_attention",
                                  _tile(2, 64, "false", 2)),
    "flash_mt2_bk32_qsmem_2blk": ("flash_attention",
                                  _tile(2, 32, "false", 2)),
    "cam_shipped": ("cam_search", []),
    "cam_no_popc": ("cam_search", [
        ("c += __popc(group_bits", "c += (int)(1u & group_bits")]),
    "cam_no_scan": ("cam_search", [
        ("if (__any_sync(0xFFFFFFFFu, cand))",
         "if (__any_sync(0xFFFFFFFFu, cand && n0 < 0))")]),
    "cam_no_compare": ("cam_search", [
        ("for (int s = 0; s < CW / SW; ++s) {",
         "for (int s = 0; s < (n0 < 0 ? CW / SW : 0); ++s) {")]),
    "enc_shipped": ("hdc_encode", []),
    "enc_tf32x1": ("hdc_encode", [
        ("      wgmma_tf32(acc, al[s], desc(pl));           // lo_x * hi_p\n"
         "      wgmma_tf32(acc, ah[s], desc(pl + PLANE));   // hi_x * lo_p\n",
         "")]),
    "enc_cvt": ("hdc_encode", [
        ("return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;",
         'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));'
         "\n  return r;")]),
    "enc_bk16_4stage": ("hdc_encode", [
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]),
    "enc_bk32_2stage": ("hdc_encode", [
        ("constexpr int BK = 16;", "constexpr int BK = 32;"),
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]),
    "mc_shipped": ("mibo_mc", []),
    "mc_rows1": ("mibo_mc", [
        ("constexpr int ROWS = 2;", "constexpr int ROWS = 1;")]),
    "mc_rows4": ("mibo_mc", [
        ("constexpr int ROWS = 2;", "constexpr int ROWS = 4;")]),
    # the field inv_ss_v carries ss itself here
    "mc_div": ("mibo_mc", [
        ("const float x = dv * d.inv_ss_v;",
         "const float x = dv / d.inv_ss_v;"),
        ("(float)(1.0 / ss_v), overdrive}", "ss_v, overdrive}")]),
    "mc_cap8": ("mibo_mc", [
        ("const long long blocks = (S + rows - 1) / rows;   // no cap per SM",
         "int dev = 0, sms = 0;\n  cudaGetDevice(&dev);\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);"
         "\n  const long long blocks = (S + rows - 1) / rows < 8LL * sms"
         "\n      ? (S + rows - 1) / rows : 8LL * sms;")]),
}
ORDER = ["flash_shipped", "flash_mt1_bk32_qsmem_4blk",
         "flash_mt1_bk32_qregs_3blk", "flash_mt1_bk64_qsmem_3blk",
         "flash_mt2_bk64_qsmem_2blk", "flash_mt2_bk32_qsmem_2blk",
         "flash_shipped", "cam_shipped", "cam_no_popc", "cam_no_scan",
         "cam_no_compare", "cam_shipped", "enc_shipped", "enc_tf32x1",
         "enc_cvt", "enc_bk16_4stage", "enc_bk32_2stage", "enc_shipped",
         "mc_shipped", "mc_rows1", "mc_rows4", "mc_div", "mc_cap8",
         "mc_shipped"]
#: the instantiation whose registers are reported, by source
ENTRY = {"flash_attention": "flash_bf16_kernelILi128",
         "cam_search": "cam_topk_partial_kernelILi3ELi64ELb0ELb0",
         "hdc_encode": "hdc_encode_kernelILb1ELb1E",
         "mibo_mc": "mibo_mc_kernelILi4E"}


def build(names):
    """name -> (loaded library, ptxas register and spill lines), the
    variants ``names`` built in parallel."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source, edits = VARIANTS[name]
        text = (_build.CSRC / f"{source}.cu").read_text()
        for old, new in edits:
            cs.check(text.count(old) >= 1, f"{name}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        keep, lines = False, []
        for line in log.splitlines():
            if "Compiling entry" in line:
                keep = ENTRY[VARIANTS[name][0]] in line
            elif keep and ("Used" in line or "spill" in line):
                lines.append(line.strip())
        libs[name] = (ctypes.CDLL(str(so)), lines)
    return libs


def encode_cases():
    """(name, x, proj, thresholds, plain codes) at each shape of the
    ``hdc_encode`` path."""
    import torch
    from repro_torch.core import quantize as q
    from repro_torch.kernels.hdc_encode import ref
    data = {name: cs._hdc_setup(name) for name in ("isolet", "ucihar",
                                                    "pamap")}
    thr = q.gaussian_thresholds(3, device="cuda")
    out = []
    for name, x, proj in cs._encode_inputs(data):
        out.append((f"{name}-{proj.shape[1]}", x, proj, thr,
                    ref.encode_quantize(x, proj, thr)))
    torch.cuda.synchronize()
    return out


def run_encode(cases):
    """Gate readings and times of the loaded hdc_encode at each case: per
    call (``ms``) and device time from a CUDA graph (``device_ms``), each
    summed over the cases."""
    from repro_torch.kernels.hdc_encode import kernel
    shapes, ok, total, total_dev = [], True, 0.0, 0.0
    for name, x, proj, thr, want in cases:
        got = kernel.hdc_encode(x, proj, thr)
        diff = (got.long() - want.long()).abs()
        frac = (diff != 0).double().mean().item()
        top = int(diff.max().item())
        passed = (frac < 5e-3 and top <= 1
                  and frac <= kernel.ENCODE_FP32_FRACTION)
        ok = ok and passed
        del got, diff
        ms = cs._time_ms(lambda: kernel.hdc_encode(x, proj, thr), 10)
        device_ms = cs._graph_ms(lambda: kernel.hdc_encode(x, proj, thr), 20)
        total += ms
        total_dev += device_ms
        shapes.append({"shape": name, "ms": ms, "device_ms": device_ms,
                       "frac_codes_differ": frac, "max_code_diff": top,
                       "passes_fp32_gate": passed})
    return {"ms": total, "device_ms": total_dev, "passes_fp32_gate": ok,
            "shapes": shapes}


def mibo_cases():
    """(S, C, args, plain currents) at 2^20 x 64 and the fig9_mc shape."""
    import torch
    from repro_torch.kernels.mibo_mc import ref
    out = []
    for s, c in (cs.MC_BIG, (cs.N_MC, cs.MC_CELLS)):
        args = cs._mibo_inputs(np.random.default_rng(cs.SEED + s + c), s, c,
                               3, torch.device("cuda"))
        out.append((s, c, args, ref.ml_currents(*args)))
    return out


def run_mibo(cases):
    """Gate readings and times of the loaded mibo_mc: per call (``ms``)
    and device time from a CUDA graph (``device_ms``), the run's own those
    of 2^20 x 64."""
    from repro_torch.kernels.mibo_mc import kernel
    shapes, ok = [], True
    for s, c, args, want in cases:
        got = kernel.mibo_mc(*args)
        diff = (got - want).abs()
        bad = int((diff > 1e-12 + 1e-5 * want.abs()).sum())
        ok = ok and bad == 0
        ms = cs._time_ms(lambda: kernel.mibo_mc(*args), 10)
        device_ms = cs._graph_ms(lambda: kernel.mibo_mc(*args), 20)
        shapes.append({"S": s, "C": c, "ms": ms, "device_ms": device_ms,
                       "max_abs_err": float(diff.max()),
                       "outside_rtol_1e-5": bad})
    return {"ms": shapes[0]["ms"], "device_ms": shapes[0]["device_ms"],
            "passes_gate": ok, "shapes": shapes}


def use(source, lib):
    from repro_torch.kernels import _build
    with _build._lock:
        _build._libs[source] = lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "kernel_variants.json"))
    ap.add_argument("--only", default="",
                    help="comma-separated name prefixes of the variants to "
                         "run (default: all)")
    args = ap.parse_args(argv)
    prefixes = tuple(p for p in args.only.split(",") if p)
    order = [n for n in ORDER if not prefixes or n.startswith(prefixes)]
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.cam_search import kernel as cam
    from repro_torch.kernels.flash_attention import kernel as fl, ops
    card = cs.phase_device()
    libs = build(sorted(set(order)))
    sources = {VARIANTS[n][0] for n in order}
    if "flash_attention" in sources:
        b, s, h, hk, dh = cs.FLASH_PATH_SHAPE
        i = cs.prefill_case()
        shape, dtype, _ = cs._flash_cases()[i]
        q4, k4, v4 = cs._flash_inputs(shape, dtype, cs.SEED + i, "cuda")
        want = cs._flash_plain_bshd(q4, k4, v4, True)
        q, k, v = (x.transpose(1, 2).reshape(-1, s, dh).contiguous()
                   for x in (q4, k4, v4))
    if "cam_search" in sources:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        t8, c8 = (torch.randint(0, 1 << cs.BITS, (n, cs.WIDTH),
                                generator=gen, device="cuda").to(torch.int8)
                  for n in (cs.CAPACITY, 1024))
        vr = torch.full((1,), cs.ROWS, dtype=torch.int32, device="cuda")
    enc_cases = encode_cases() if "hdc_encode" in sources else None
    mc_cases = mibo_cases() if "mibo_mc" in sources else None
    runs = []
    for name in order:
        source = VARIANTS[name][0]
        lib, ptxas = libs[name]
        use(source, lib)
        if source == "flash_attention":
            got = ops.flash_attention_bshd(q4, k4, v4, causal=True)
            err, row = cs._flash_close(got, want, 3e-2, name)
            ms = cs._time_ms(lambda: fl.flash_attention(q, k, v,
                                                        group=h // hk), 20)
            extra = {"max_abs_err": err, "max_row_rel_l2": row}
        elif source == "hdc_encode":
            extra = run_encode(enc_cases)
            ms = extra.pop("ms")
        elif source == "mibo_mc":
            extra = run_mibo(mc_cases)
            ms = extra.pop("ms")
        else:
            ms = cs._time_ms(lambda: cam.cam_search_topk(
                c8, t8, vr, levels=1 << cs.BITS, k=cs.K), 10)
            extra = {}
        runs.append({"variant": name, "ms": ms, "ptxas": ptxas, **extra})
        dev = (f" device_ms={extra['device_ms']:.4f}"
               if "device_ms" in extra else "")
        print(f"{name}: ms={ms:.4f}{dev} {' | '.join(ptxas)}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    def gate(name):
        return [r["passes_fp32_gate"] for r in runs if r["variant"] == name]
    if not all(gate("enc_shipped")) or any(gate("enc_tf32x1")):
        print(f"kernel_variants: ENCODE_FP32_FRACTION does not separate the "
              f"shipped hdc_encode (passes: {gate('enc_shipped')}) from "
              f"tf32x1 (passes: {gate('enc_tf32x1')})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
