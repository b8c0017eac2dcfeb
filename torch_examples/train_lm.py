"""End-to-end LM training driver: trains the smoke config of an arch for a
few hundred steps with the full stack — synthetic data pipeline, AdamW +
cosine schedule, async checkpointing, watchdog/straggler fault tolerance —
and verifies the loss goes down.

Port of ``examples/train_lm.py`` on :mod:`repro_torch.launch.train`.

  PYTHONPATH=src python torch_examples/train_lm.py --steps 300   # GPU
  PYTHONPATH=src python torch_examples/train_lm.py --device cpu
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()

    state, report, wall = train(args.arch, smoke=True, steps=args.steps,
                                batch=args.batch, seq=args.seq,
                                ckpt_dir=args.ckpt_dir, device=args.device)
    l = report.losses
    print(f"\nsteps={report.final_step} wall={wall:.1f}s "
          f"({1e3 * wall / max(report.final_step, 1):.0f} ms/step) "
          f"restarts={report.restarts} stragglers={len(report.straggler_flags)}")
    k = max(len(l) // 10, 1)
    print(f"loss: start={sum(l[:k]) / k:.4f} end={sum(l[-k:]) / k:.4f}")
    if not sum(l[-k:]) / k < sum(l[:k]) / k:
        raise AssertionError("loss did not improve")
    print("OK: loss decreased; checkpoints in", args.ckpt_dir)


if __name__ == "__main__":
    main()
