"""Sharding rules: one ``Rules`` object maps logical tensors to mesh axes.

Port of :mod:`repro.dist.specs`.  The reference maps each logical tensor
role to a ``PartitionSpec``; here a spec is a plain tuple with one entry
per tensor dimension: ``None`` for a replicated dimension, or the mesh
axis name (or a tuple of names) the dimension is split over.  The
``layout`` string of :class:`repro_torch.configs.base.ParallelCfg`
selects the bindings:

  ``"tp"``  Megatron tensor parallelism: head/FF dims on ``model``,
            optional sequence-parallel residual stream, FSDP weights over
            ``data``.
  ``"cp"``  Context parallelism: heads stay unsharded, the sequence axis
            is sharded over ``model``, weights are 2-D FSDP.

Spec factories (shapes they describe):

  ``act_resid``      (B, S, D)     residual-stream activations
  ``act_heads``      (B, S, H, dh) attention activations, heads on tp
  ``act_seq_heads``  (B, S, H, dh) attention activations, sequence on tp
  ``act_ff``         (B, S, F)     feed-forward hidden activations
  ``w2``             (d_in, d_out) column-parallel 2-D weight
  ``w2_row``         (d_in, d_out) row-parallel 2-D weight
  ``embed``          (V, D)        embedding table (vocab on tp, D on fsdp)
  ``logits``         (B, S, V)     output logits
  ``am_table``       (N, D)        code rows banked on tp
  ``am_queries``     (Q, D)        queries, replicated
  ``am_queries_dp``  (Q, D)        queries, batch on the dp axes
  ``am_meta``        (N, M)        per-row serving meta, replicated
  ``am_index``       (S,)          per-set index arrays, S on tp
  ``am_state``       the spec tree of one durable table state

What reads them: the multi-bank search reads the AM specs to decide which
dimension is banked and whether the query batch is split, exactly where
the reference hands them to ``shard_map``; the training step reads the
weight specs (through :func:`repro_torch.models.transformer.param_specs`)
to shard the optimizer state over ``fsdp``
(:mod:`repro_torch.train.optimizer`) and ``dp`` to split the batch.  The
activation specs (``act_*``, ``logits``) are kept for the spec trees'
sake: the port has no tensor-parallel forward, so nothing places an
activation by them.

Not here: the reference's ``constrain`` is a GSPMD placement hint
(``with_sharding_constraint``).  It never changes a value, and PyTorch has
no compiler that places tensors by such a hint, so it has no counterpart;
the port's model code calls nothing in its place.
"""

from __future__ import annotations

import dataclasses

#: Mesh axes considered data-parallel, outermost first.
DP_AXES = ("pod", "data")
#: The tensor-parallel (bank) mesh axis.
TP_AXIS = "model"
#: The weight-sharding (FSDP) mesh axis.
FSDP_AXIS = "data"

LAYOUTS = ("tp", "cp")


@dataclasses.dataclass(frozen=True)
class Rules:
    """Axis bindings for one (mesh, layout) pair.

    Attributes:
      layout: ``"tp"`` or ``"cp"``.
      tp:     the tensor-parallel (bank) axis name; ``mesh.shape[rules.tp]``
              is the bank count.
      dp:     tuple of batch axes, or ``None`` when the batch is replicated.
      fsdp:   the weight-sharding axis name, or ``None``.
      resid_seq_shard: sequence-parallel residual stream (Megatron-SP) in
              the ``tp`` layout; the ``cp`` layout always sequence-shards.
    """

    layout: str
    tp: str
    dp: tuple | None
    fsdp: str | None = None
    resid_seq_shard: bool = True

    # -- activations ---------------------------------------------------------

    def act_resid(self) -> tuple:
        """(B, S, D) residual stream: B on dp, S on tp when sequence-sharded."""
        if self.layout == "cp" or self.resid_seq_shard:
            return (self.dp, self.tp, None)
        return (self.dp, None, None)

    def act_heads(self) -> tuple:
        """(B, S, H, dh): B on dp; H on tp (Megatron) or S on tp under cp."""
        if self.layout == "tp":
            return (self.dp, None, self.tp, None)
        return (self.dp, self.tp, None, None)

    def act_seq_heads(self) -> tuple:
        """(B, S, H, dh): B on dp, S on tp (context parallel), H replicated."""
        return (self.dp, self.tp, None, None)

    def act_ff(self) -> tuple:
        """(B, S, F): B on dp; F on tp (Megatron) or S on tp under cp."""
        if self.layout == "tp":
            return (self.dp, None, self.tp)
        return (self.dp, self.tp, None)

    # -- weights -------------------------------------------------------------

    def w2(self) -> tuple:
        """(d_in, d_out) column-parallel weight: d_out on tp, d_in on fsdp."""
        return (self.fsdp, self.tp)

    def w2_row(self) -> tuple:
        """(d_in, d_out) row-parallel weight: d_in on tp, d_out on fsdp."""
        return (self.tp, self.fsdp)

    def embed(self) -> tuple:
        """(V, D) embedding table: V on tp, D on fsdp (the transpose is the
        tied LM head)."""
        return (self.tp, self.fsdp)

    # -- associative memory ----------------------------------------------------

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

    # -- outputs -------------------------------------------------------------

    def logits(self) -> tuple:
        """(B, S, V): B on dp; V on tp (tp) or S on tp (cp)."""
        if self.layout == "tp":
            return (self.dp, None, self.tp)
        return (self.dp, self.tp, None)


def make_rules(mesh, layout: str, *, batch_size: int | None = None,
               resid_seq_shard: bool = True) -> Rules:
    """Bind a :class:`Rules` to ``mesh``, by the reference's rule.

    ``tp`` is ``"model"`` when the mesh has it, else its last axis.  The
    dp axes are those of ``("pod", "data")`` the mesh has other than
    ``tp``, outermost first; with ``batch_size`` they are kept only while
    their product still divides it (a batch of 1 is replicated).
    ``fsdp`` is ``"data"`` when the mesh has it and ``tp`` is another
    axis, else ``None``.  So on a mesh whose only axis is ``data``, ``tp``
    binds to ``data`` and nothing shards the weights: a mesh that shards
    the optimizer state over ``data`` is ``("data", "model")``, with
    ``model`` of width 1 where there is no tensor parallelism.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")
    names = tuple(mesh.axis_names)
    tp = TP_AXIS if TP_AXIS in names else names[-1]
    dp = tuple(a for a in DP_AXES if a in names and a != tp)
    if batch_size is not None:
        kept: list = []
        prod = 1
        for axis in dp:
            if batch_size % (prod * mesh.shape[axis]) != 0:
                break
            kept.append(axis)
            prod *= mesh.shape[axis]
        dp = tuple(kept)
    fsdp = FSDP_AXIS if (FSDP_AXIS in names and FSDP_AXIS != tp) else None
    return Rules(layout=layout, tp=tp, dp=dp or None, fsdp=fsdp,
                 resid_seq_shard=resid_seq_shard)
