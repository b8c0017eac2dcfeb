"""Elastic rescaling: restore a checkpoint onto another bank count.

Port of :mod:`repro.checkpoint.elastic`.  Checkpoints store logical (full)
arrays, and in this package a bank is a row view of the one slab: on a
:class:`~repro_torch.dist.LocalMesh` each of ``B`` banks reads
``ceil(N / B)`` rows of the table, and each rank of a
:class:`~repro_torch.dist.ProcessGroupMesh` holds the whole table and
searches its own rows (``am.search_sharded``).  So restoring onto a mesh
restores the full arrays; the spec tree is checked against the mesh (every
axis name it binds must be one of the mesh's, and no spec may have more
entries than its leaf has dimensions), and the arrays go to the searches
of that mesh as they are.  No row count needs to divide the bank count.
The reference instead materialises per-device shards and replicates the
leaves whose rows do not divide the mesh.

A training state restores whole, too: a
:class:`~repro_torch.train.train_step.ShardedTrainStep` on the new mesh
splits its optimizer state over that mesh's ``fsdp`` axis on its first
update (or at once, through its ``shard_state``).
"""

from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                 leaves_with_paths)


def is_spec(x) -> bool:
    """A spec tuple of :mod:`repro_torch.dist.specs`: one entry per
    dimension, each ``None``, an axis name or a tuple of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def _axis_names(spec) -> list[str]:
    out = []
    for e in spec:
        if e is not None:
            out.extend((e,) if isinstance(e, str) else e)
    return out


def check_specs(spec_tree: Any, template: Any, mesh) -> None:
    """Raise if a spec of ``spec_tree`` does not fit ``mesh`` or its leaf.

    Specs match template leaves by key path; a spec tree may carry
    ``None`` anywhere or cover a subset of the leaves.
    """
    ndim = {p: len(x.shape) for p, x in leaves_with_paths(template)}
    for path, spec in leaves_with_paths(spec_tree, is_leaf=is_spec):
        if not is_spec(spec):
            raise TypeError(f"spec at {path!r} is {spec!r}, not a spec tuple")
        unknown = [a for a in _axis_names(spec) if a not in mesh.axis_names]
        if unknown:
            raise ValueError(f"spec {spec} at {path!r} names axes {unknown} "
                             f"the mesh {mesh} does not have")
        if path in ndim and len(spec) > ndim[path]:
            raise ValueError(f"spec {spec} at {path!r} has {len(spec)} "
                             f"entries for a {ndim[path]}-d leaf")


def reshard_restore(ckpt: Checkpointer, target_template: Any,
                    spec_tree: Any, new_mesh, step: int | None = None, *,
                    device=None) -> tuple[Any, dict]:
    """Restore ``ckpt`` for ``new_mesh`` with logical specs ``spec_tree``.

    Returns (tree, metadata) as :meth:`Checkpointer.restore`, every leaf
    the full logical array on ``device`` (default the GPU).
    """
    check_specs(spec_tree, target_template, new_mesh)
    return ckpt.restore(target_template, step=step, device=device)
