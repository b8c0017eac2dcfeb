"""Mesh construction for the launch drivers.

Port of :mod:`repro.launch.mesh`.  Both functions build a
:class:`repro_torch.dist.LocalMesh`: named axes over the banks of one
device, since the card is one GPU.  ``make_production_mesh`` keeps the
reference's named shape — (data=16, model=16), or (pod=2, data=16,
model=16) — which on one card means 16 banks of the table on the
``model`` axis, each a slice of the card's rows, and query batches that
split 16 (or 32) ways over the replicas, all of which are that one card.
"""

from __future__ import annotations

from repro_torch.dist import LocalMesh


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """(data=16, model=16) single-pod; (pod=2, data=16, model=16) multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LocalMesh(shape, axes)


def make_test_mesh(shape=(1, 1), axes=("data", "model")) -> LocalMesh:
    """A small local mesh: by default one bank and one replica."""
    return LocalMesh(shape, axes)
