#!/usr/bin/env python3
"""Planted-fault check of ``chip_smoke.py``'s flash-attention gates, on one
NVIDIA GPU.

    python3 scripts/flash_fault_check.py [--out chiprun_out/flash_faults.json]

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it is and two copies
with a fault planted at build time in its bfloat16 (tensor-core) kernel,
the one the gates run (the copies are written under
``build/repro_torch/faults/``; the sources of the repo are not touched):

- ``skip_tile``: query tiles 32 and later (rows 2,048 and on at 64 rows a
  tile) skip key tile 1 (keys 64-127: every key of it counts as masked),
  an error near 0.003 in a late row's values of about 0.03;
- ``kv_head``: query head ``bh`` reads KV head ``bh % (BH / group)``
  instead of ``bh / group``.

Each fault's text anchors must occur exactly once in the source.

Each build is swapped in as the library the wrapper loads, then run
through the two gates of ``chip_smoke.py`` that hold the flash path:
phase 2's check at the LM's prefill shape (``_flash_close``: elementwise
3e-2 and each row's relative L2 error) and ``lm_prefill``'s comparison of
yi-6b's flash forward with its einsum forward (``_lm_gate``).  Besides
each gate's verdict it reports the readings the gates see, and for the
kernel also how many values fall outside atol 1e-3, rtol 2e-2.

Exits 0 when the unchanged kernel passes both gates and each planted
fault fails the kernel gate; the LM gate's verdict on each fault is
reported, not required.  The full report goes to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

FAULTS = {
    "skip_tile": [("const bool edge = ",
                   "const bool skip = qi >= 32 && kt == 1;\n"
                   "    const bool edge = skip || "),
                  ("const bool keep = ", "const bool keep = !skip && ")],
    "kv_head": [("const int kvh = bh / group;",
                 "const int kvh = bh % (BH / group);")],
}


def build_faults():
    """name -> loaded library of each planted fault, built in parallel."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in FAULTS.items():
        text = src
        for old, new in edits:
            cs.check(text.count(old) == 1,
                     f"{name}: {old!r} is not in the source exactly once")
            text = text.replace(old, new)
        cu = out_dir / f"flash_attention_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"libflash_attention_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def use(lib):
    """Make the flash wrapper launch ``lib``'s kernel."""
    from repro_torch.kernels import _build
    with _build._lock:
        _build._libs["flash_attention"] = lib


def verdict(fn):
    """(passed, message) of one gate."""
    try:
        fn()
        return True, ""
    except cs.SmokeFailure as e:
        return False, str(e)


def kernel_readings(q, k, v, want):
    import torch
    from repro_torch.kernels.flash_attention import ops
    got = ops.flash_attention_bshd(q, k, v, causal=True)
    torch.cuda.synchronize()
    passed, why = verdict(lambda: cs._flash_close(got, want, 3e-2, "fault"))
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rows = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    half = rows.shape[1] // 2
    return {"gate_passed": passed, "gate_message": why,
            "max_abs_diff": float(diff.max()),
            "outside_3e-2": int((diff > 3e-2 + 3e-2 * w.abs()).sum()),
            "outside_atol1e-3_rtol2e-2": int(
                (diff > 1e-3 + 2e-2 * w.abs()).sum()),
            "max_row_rel_l2": float(rows.max()),
            "max_row_rel_l2_first_half": float(rows[:, :half].max()),
            "max_row_rel_l2_second_half": float(rows[:, half:].max()),
            "min_row_rel_l2_second_half": float(rows[:, half:].min()),
            "median_row_rel_l2": float(rows.float().median())}


def lm_readings(params, flash, tokens, want):
    import torch
    from repro_torch.models import transformer
    got, _ = transformer.forward(params, flash, tokens)
    torch.cuda.synchronize()
    out = cs._lm_readings(got, want, tokens)
    passed, why = verdict(lambda: cs._lm_gate(out))
    g, w = got.float(), want.float()
    g.scatter_(-1, tokens[..., None], 0.0)
    w.scatter_(-1, tokens[..., None], 0.0)
    half = g.shape[1] // 2
    for part, sl in (("first_half", slice(None, half)),
                     ("second_half", slice(half, None))):
        out[f"logit_rel_l2_{part}"] = float(
            (g[:, sl] - w[:, sl]).norm() / w[:, sl].norm())
    return {"gate_passed": passed, "gate_message": why, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "flash_faults.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_fault_check: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.models import transformer
    card = cs.phase_device()
    t0 = time.perf_counter()
    libs = {"sound": _build.load("flash_attention"), **build_faults()}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    i = cs.prefill_case()
    shape, dtype, _ = cs._flash_cases()[i]
    q, k, v = cs._flash_inputs(shape, dtype, cs.SEED + i, "cuda")
    want = cs._flash_plain_bshd(q, k, v, True)
    report = {"card": card, "shape": shape, "kernel": {}, "lm": {}}
    for name, lib in libs.items():
        use(lib)
        report["kernel"][name] = kernel_readings(q, k, v, want)
    del q, k, v, want

    cfg, flash, params, _, tokens = cs._lm_setup()
    want, _ = transformer.forward(params, cfg, tokens)
    for name, lib in libs.items():
        use(lib)
        report["lm"][name] = lm_readings(params, flash, tokens, want)
    use(libs["sound"])

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    for part in ("kernel", "lm"):
        for name, r in report[part].items():
            print(part, name, json.dumps(
                {k: v for k, v in r.items() if k != "gate_message"}))
    ok = (report["kernel"]["sound"]["gate_passed"]
          and report["lm"]["sound"]["gate_passed"]
          and not any(report["kernel"][n]["gate_passed"] for n in FAULTS))
    print(card)
    print(json.dumps({"ok": ok, "lm_gate_fails": {
        n: not report["lm"][n]["gate_passed"] for n in FAULTS}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
