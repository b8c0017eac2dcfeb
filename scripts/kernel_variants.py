#!/usr/bin/env python3
"""Time build-time variants of the port's two redesigned kernels on one
NVIDIA GPU, at the shapes of their main paths.

    python3 scripts/kernel_variants.py [--out chiprun_out/kernel_variants.json]

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

Prints one line per run and writes the readings, with the card's name and
power limit, to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

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
}
ORDER = ["flash_shipped", "flash_mt1_bk32_qsmem_4blk",
         "flash_mt1_bk32_qregs_3blk", "flash_mt1_bk64_qsmem_3blk",
         "flash_mt2_bk64_qsmem_2blk", "flash_mt2_bk32_qsmem_2blk",
         "flash_shipped", "cam_shipped", "cam_no_popc", "cam_no_scan",
         "cam_no_compare", "cam_shipped"]


def build():
    """name -> (loaded library, ptxas register and spill lines), all
    variants built in parallel."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, edits) in VARIANTS.items():
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
                keep = ("flash_bf16_kernelILi128" in line
                        or "cam_topk_partial_kernelILi3ELi64ELb0ELb0" in line)
            elif keep and ("Used" in line or "spill" in line):
                lines.append(line.strip())
        libs[name] = (ctypes.CDLL(str(so)), lines)
    return libs


def use(source, lib):
    from repro_torch.kernels import _build
    with _build._lock:
        _build._libs[source] = lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "kernel_variants.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.cam_search import kernel as cam
    from repro_torch.kernels.flash_attention import kernel as fl, ops
    card = cs.phase_device()
    libs = build()
    b, s, h, hk, dh = cs.FLASH_PATH_SHAPE
    i = cs.prefill_case()
    shape, dtype, _ = cs._flash_cases()[i]
    q4, k4, v4 = cs._flash_inputs(shape, dtype, cs.SEED + i, "cuda")
    want = cs._flash_plain_bshd(q4, k4, v4, True)
    q, k, v = (x.transpose(1, 2).reshape(-1, s, dh).contiguous()
               for x in (q4, k4, v4))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    t8, c8 = (torch.randint(0, 1 << cs.BITS, (n, cs.WIDTH), generator=gen,
                            device="cuda").to(torch.int8)
              for n in (cs.CAPACITY, 1024))
    vr = torch.full((1,), cs.ROWS, dtype=torch.int32, device="cuda")
    runs = []
    for name in ORDER:
        source = VARIANTS[name][0]
        lib, ptxas = libs[name]
        use(source, lib)
        if source == "flash_attention":
            got = ops.flash_attention_bshd(q4, k4, v4, causal=True)
            err, row = cs._flash_close(got, want, 3e-2, name)
            ms = cs._time_ms(lambda: fl.flash_attention(q, k, v,
                                                        group=h // hk), 20)
            extra = {"max_abs_err": err, "max_row_rel_l2": row}
        else:
            ms = cs._time_ms(lambda: cam.cam_search_topk(
                c8, t8, vr, levels=1 << cs.BITS, k=cs.K), 10)
            extra = {}
        runs.append({"variant": name, "ms": ms, "ptxas": ptxas, **extra})
        print(f"{name}: ms={ms:.4f} {' | '.join(ptxas)}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
