"""``repro_torch.checkpoint`` — durable, mesh-agnostic checkpoints.

Port of :mod:`repro.checkpoint`'s ``checkpointer``, ``elastic`` and
``fault_tolerance`` (the restartable training loop), in the reference's
on-disk format (npy leaves + a JSON manifest, bf16 as uint16).
"""

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
from repro_torch.checkpoint.elastic import reshard_restore  # noqa: F401
