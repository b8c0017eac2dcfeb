"""``repro_torch.checkpoint`` — durable, mesh-agnostic checkpoints.

Port of :mod:`repro.checkpoint`'s ``checkpointer`` and ``elastic``, in the
reference's on-disk format (npy leaves + a JSON manifest, bf16 as uint16).
Its ``fault_tolerance`` module comes with training.
"""

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
from repro_torch.checkpoint.elastic import reshard_restore  # noqa: F401
