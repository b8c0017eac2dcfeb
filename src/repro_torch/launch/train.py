"""End-to-end training driver.

Port of :mod:`repro.launch.train`: real steps (synthetic data pipeline,
AdamW, checkpoints, fault tolerance) on the GPU, or on the CPU with
``--device cpu``; ``train(..., mesh=)`` runs them data-parallel with the
optimizer state sharded over the mesh's ``data`` axis.  Like the reference it defaults to the smoke
config (``--smoke`` is on; ``--full`` asks for the published geometry).

  python -m repro_torch.launch.train --arch yi-6b --steps 50 --batch 8 \\
      --seq 128                                   # on the GPU
  python -m repro_torch.launch.train --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.fault_tolerance import FaultTolerantLoop
from repro_torch.configs.registry import ALIASES, get_config
from repro_torch.data import lm_synth
from repro_torch.device import resolve_device
from repro_torch.dist.specs import make_rules
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

SEED = 0


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str, lr: float = 3e-4, mesh=None, ckpt_every: int = 20,
          fault_injector=None, device=None, cfg=None):
    """Train ``arch`` for ``steps`` steps; returns (state, report, wall s).

    ``mesh`` (default ``make_test_mesh()``, one bank and one replica)
    binds the rules, ``make_rules(mesh, layout, batch_size=batch)``, as
    the reference's driver does: where its ``data`` axis is wider than 1
    the step splits the batch over dp and shards the optimizer state over
    ``data`` (:class:`~repro_torch.train.train_step.ShardedTrainStep`).
    On a :class:`~repro_torch.dist.ProcessGroupMesh` every rank calls
    this, each with its own ``ckpt_dir``.  ``cfg`` replaces the
    registry's config of ``arch`` (a depth-cut config, say).  Weights are
    drawn from a generator seeded with :data:`SEED` on ``device``
    (default the GPU).
    """
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(ALIASES.get(arch, arch), smoke=smoke)
    if mesh is None:
        mesh = make_test_mesh()
    rules = make_rules(mesh, cfg.parallel.layout, batch_size=batch)
    data_cfg = lm_synth.LMDataCfg(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch)
    opt_cfg = opt.OptCfg(lr=lr, warmup_steps=max(steps // 10, 1),
                         decay_steps=steps)

    def init_state():
        return ts.init_state(cfg, torch.Generator(device=dev).manual_seed(
            SEED))

    def batch_fn(step: int):
        batch = ts.to_device(lm_synth.batch_at(data_cfg, step), dev)
        if cfg.frontend is not None:
            # the stub frontend's prefix: zero embeddings, as the
            # reference's driver feeds
            batch["embeds"] = torch.zeros(
                (batch["tokens"].shape[0], cfg.n_prefix_embeds,
                 transformer.STUB_FRONTEND_DIM), dtype=torch.float32,
                device=dev)
        return batch

    ckpt = Checkpointer(ckpt_dir, keep=2)
    loop = FaultTolerantLoop(
        step_fn=ts.make_train_step(cfg, opt_cfg, mesh, rules),
        init_state=init_state,
        batch_fn=batch_fn, ckpt=ckpt, ckpt_every=ckpt_every,
        watchdog_s=600.0, fault_injector=fault_injector)
    t0 = time.time()
    state, report = loop.run(steps)
    wall = time.time() - t0
    return state, report, wall


def parse_args(argv=None):
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    state, report, wall = train(args.arch, args.smoke, args.steps,
                                args.batch, args.seq, args.ckpt_dir, args.lr,
                                device=args.device)
    losses = report.losses
    print(f"arch={args.arch} steps={report.final_step} wall={wall:.1f}s "
          f"restarts={report.restarts}")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"min={min(losses):.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("training did not reduce loss")
    return report


if __name__ == "__main__":
    main()
