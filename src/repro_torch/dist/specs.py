"""Axis bindings of the associative-memory tensors on a named mesh.

Port of the associative-memory half of :mod:`repro.dist.specs`.  The
reference maps each logical tensor role to a ``PartitionSpec``; here a
spec is a plain tuple with one entry per tensor dimension: ``None`` for a
replicated dimension, or the mesh axis name (or a tuple of names) the
dimension is split over.  The search code reads them to decide which
dimension is banked and whether the query batch is split, exactly where
the reference hands them to ``shard_map``.

  ``am_table``       (N, D)  code rows banked on tp
  ``am_queries``     (Q, D)  queries, replicated
  ``am_queries_dp``  (Q, D)  queries, batch on the dp axes
  ``am_meta``        (N, M)  per-row serving meta, replicated
  ``am_index``       (S,)    per-set index arrays, S on tp
  ``am_state``       the spec tree of one durable table state

The LM roles (``act_resid``, ``w2``, ``embed``, ...) and the ``fsdp`` and
``resid_seq_shard`` fields they read come with multi-card training
(ROADMAP item 11c).
"""

from __future__ import annotations

import dataclasses

#: Mesh axes considered data-parallel, outermost first.
DP_AXES = ("pod", "data")
#: The tensor-parallel (bank) mesh axis.
TP_AXIS = "model"

LAYOUTS = ("tp", "cp")


@dataclasses.dataclass(frozen=True)
class Rules:
    """Axis bindings for one (mesh, layout) pair.

    Attributes:
      layout: ``"tp"`` or ``"cp"``.
      tp:     the bank (tensor-parallel) axis name; ``mesh.shape[rules.tp]``
              is the bank count.
      dp:     tuple of batch axes, or ``None`` when the batch is replicated.
    """

    layout: str
    tp: str
    dp: tuple | None

    def am_table(self) -> tuple:
        """(N, D) code table: N (rows) on tp, D replicated.

        Each bank holds a contiguous run of ``ceil(N / banks)`` rows and
        searches it alone; :func:`repro_torch.core.am.search_sharded`
        reduces the per-bank top-k candidates along this axis.
        """
        return (self.tp, None)

    def am_queries(self) -> tuple:
        """(Q, D) queries: fully replicated; every bank sees the batch."""
        return (None, None)

    def am_queries_dp(self) -> tuple:
        """(Q, D) queries: Q on the dp axes, D replicated.

        Each data-parallel slice searches only its own query shard against
        all banks.  Needs Q to divide the total dp width;
        :func:`repro_torch.core.am.search_sharded` picks this spec exactly
        when it does.
        """
        return (self.dp, None)

    def am_meta(self) -> tuple:
        """(N, M) per-row serving meta: replicated on every bank."""
        return (None, None)

    def am_index(self) -> tuple:
        """(S, ...) per-set index arrays: S (sets) on tp, the rest replicated.

        Each bank owns a contiguous run of whole sets and fine-scores only
        the probed sets it owns; the (S, D) centroid table stays replicated
        (the coarse pass runs once, outside the banks).
        """
        return (self.tp,)

    def am_state(self, *, ternary: bool = False,
                 indexed: bool = False) -> dict:
        """Spec tree of one durable table-state dict (the snapshot layer).

        Keyed exactly like the state :mod:`repro_torch.serve.snapshot`
        serialises per table: ``codes`` row-banked per :meth:`am_table`,
        ``meta`` per :meth:`am_meta`, the pickled ``values`` byte plane
        replicated (host payloads have no device layout), plus, when the
        flags say the table carries them, the ternary ``care`` plane
        (banked with its codes) and the five ``index`` arrays (set-banked
        per :meth:`am_index`, except the replicated coarse ``centroids``).
        :func:`repro_torch.checkpoint.elastic.reshard_restore` checks it
        against the mesh a snapshot is restored onto.
        """
        state: dict = {"codes": self.am_table(), "meta": self.am_meta(),
                       "values": ()}
        if ternary:
            state["care"] = self.am_table()
        if indexed:
            state["index"] = {
                "centroids": (),
                "slabs": self.am_index(),
                "row_ids": self.am_index(),
                "set_sizes": self.am_index(),
                "set_radius": self.am_index(),
            }
        return state


def make_rules(mesh, layout: str) -> Rules:
    """Bind a :class:`Rules` to ``mesh``, by the reference's rule.

    The bank axis is ``"model"`` when the mesh has it, else its last axis;
    the dp axes are those of ``("pod", "data")`` the mesh has, outermost
    first.  (The reference's ``batch_size=`` comes with the LM roles.)
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")
    names = tuple(mesh.axis_names)
    tp = TP_AXIS if TP_AXIS in names else names[-1]
    dp = tuple(a for a in DP_AXES if a in names and a != tp)
    return Rules(layout=layout, tp=tp, dp=dp or None)
