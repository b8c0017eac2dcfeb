"""The two readings behind the HDC cell's check margin, on the card.

    PYTHONPATH=src python scripts/hdc_check_margin.py --seeds 1,2,3

For each seed it makes the ``hdc_isolet_d4096.bulk_k1`` cell's inputs, draws
as many keys as a run checks, and codes their features three ways: the
fused ``hdc_encode`` kernel (the program), a 3xTF32 product emulated in
float32 (``kernels/hdc_encode/ref.tf32_product``) and the reference's own
control, a single TF32 product (``ambench/references/hdc_classify.py``).
Against the reference's plain float32 codes it prints, for each, the share
of codes that differ, the largest and the median distance of a differing
symbol's product from its threshold in units of the check's scale (the
reference's ``codes``), and how many top-1 answers the check finds
mismatched.  The margin (``AMBIGUOUS``) has to lie above the kernel's
largest reading and the single TF32 answers have to fail.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from ambench import registry, run, traffic  # noqa: E402

CELL = "hdc_isolet_d4096.bulk_k1"


def readings(seed: int, device, *, config_over=None, mix_over=None) -> list:
    """One dict a way of coding the seed's checked features."""
    from repro_torch.kernels.hdc_encode import ops, ref

    bench = registry.benchmark()
    cfg = run._update(registry.config(bench, registry.cell(
        bench, CELL)["config"]), config_over)
    mix = run._update(registry.traffic(registry.cell(bench, CELL)["traffic"]),
                      mix_over)
    system = registry.module("systems", cfg["system"])
    reference = registry.module("references", cfg["reference"])
    seeds = traffic.seeds(seed)
    inputs = system.make_inputs(cfg, mix, seeds["rows"], device)
    keys = traffic.Keys(mix, inputs.words.shape[0], seeds["keys"],
                        seeds["order"]).draw(run.CHECK_LOOKUPS)
    x = inputs.words[torch.as_tensor(keys, device=inputs.words.device)]
    proj, classes = inputs.stored.projection, inputs.stored.codes.long()
    want = reference.expected(inputs.stored, x, cfg, 1, device)
    plain, margin, _ = reference.codes(x, proj)
    thr = torch.tensor(reference.hdc_standin.THRESHOLDS_3BIT,
                       device=x.device)
    ways = {"kernel": lambda: ops.encode_quantize(x, proj, 3),
            "3xtf32_emulated": lambda: ref.codes_from_product(
                ref.tf32_product(x, proj, terms=3), x, thr),
            "tf32": lambda: reference.codes(x, proj, single_tf32=True)[0]}
    out = []
    for name, codes in ways.items():
        if name == "kernel" and x.device.type != "cuda":
            continue
        c = codes()
        flipped = margin[c != plain]
        d = (c.long()[:, None, :] - classes[None]).abs().sum(dim=-1)
        key = (d * d.shape[1] + torch.arange(d.shape[1], device=d.device)
               ).min(dim=1).values.cpu().numpy()
        answers = [reference.Answer([k % d.shape[1]], [k // d.shape[1]])
                   for k in key]
        out.append({
            "seed": seed, "codes": name, "queries": len(keys),
            "differing_share": float((c != plain).float().mean()),
            "margin_max": float(flipped.max()) if flipped.numel() else 0.0,
            "margin_median": (float(flipped.median()) if flipped.numel()
                              else 0.0),
            "mismatched": reference.mismatched(answers, want),
            "limit_margin": reference.AMBIGUOUS})
    out.append({"seed": seed, "ambiguous_queries": int(sum(
        m.shape[0] > 0 for m in want["moves"])), "queries": len(keys)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(json.dumps({"card": torch.cuda.get_device_name(dev)}))
    for s in args.seeds.split(","):
        for row in readings(int(s), dev):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
