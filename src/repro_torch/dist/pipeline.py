"""GPipe pipeline parallelism over the ``pod`` mesh axis.

Port of :mod:`repro.dist.pipeline` on the port's meshes
(:mod:`repro_torch.dist.mesh`).  Each pod holds one pipeline *stage* — a
contiguous slice of layers.  The forward runs the classic GPipe schedule:
``n_micro`` microbatches flow through ``n_stages`` stages over
``n_micro + n_stages - 1`` ticks, activations rotating stage-to-stage
through ``ppermute`` after every tick.  At tick ``t`` stage ``s`` works on
microbatch ``t - s``; out-of-range ticks (the fill/drain bubble) compute
garbage that is never read, as the reference's do.  The bubble cost is
:func:`bubble_fraction` = (S-1)/(S-1+M).

On a :class:`~repro_torch.dist.LocalMesh` every stage is a slice of one
device and the stages of a tick run one after the other; on a
:class:`~repro_torch.dist.ProcessGroupMesh` each rank runs its own stage
and ``ppermute`` is a ``batch_isend_irecv``.  Every stage receives the
whole input: batch axes named by ``in_spec`` are replicas here.

Outputs: every stage writes its per-tick result into a local
``(n_micro, ...)`` buffer, and the buffers are stacked along axis 0 in
stage order, on every rank, so callers slice the last stage's block for
the valid, fully-propagated microbatch outputs.
"""

from __future__ import annotations

import torch

PP_AXIS = "pod"


def bubble_fraction(stages: int, micro: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1) / (S-1 + M)."""
    if stages < 1 or micro < 1:
        raise ValueError((stages, micro))
    return (stages - 1) / (stages - 1 + micro)


def _layer(params, i: int):
    """``params`` with the leading layer axis of every leaf indexed at i."""
    if isinstance(params, dict):
        return {k: _layer(v, i) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_layer(v, i) for v in params)
    return params[i]


def make_pp_forward(block_apply, n_layers: int, n_stages: int, n_micro: int,
                    mesh, in_spec: tuple):
    """Build the pipelined forward ``fwd(params, x) -> stacked outputs``.

    Args:
      block_apply: ``(layer_params, x) -> x`` for ONE layer;
        ``layer_params`` is the params tree with the leading layer axis
        indexed away.
      n_layers: total layer count; must divide evenly into ``n_stages``.
      n_stages: pipeline depth; must equal ``mesh.shape["pod"]``.
      n_micro: number of microbatches (the leading axis of ``x``).
      mesh: a mesh containing a ``pod`` axis.
      in_spec: spec of ``x`` in the port's convention (a tuple, one entry
        per dimension, see :mod:`repro_torch.dist.specs`) —
        ``(n_micro, batch, ...)`` with the microbatch axis unsharded.

    Returns:
      ``fwd(params, x)`` where ``params`` leaves carry a leading
      ``n_layers`` axis (stage ``s`` uses layers ``[s * L / S, (s + 1) *
      L / S)``) and ``x`` is ``(n_micro, batch, ...)``.  The result is
      ``(n_stages * n_micro, batch, ...)``: per-stage output buffers
      stacked along axis 0, the last stage's block holding the valid
      outputs.
    """
    if PP_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {PP_AXIS!r} axis")
    if mesh.shape[PP_AXIS] != n_stages:
        raise ValueError(f"n_stages={n_stages} != mesh {PP_AXIS} size "
                         f"{mesh.shape[PP_AXIS]}")
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by {n_stages}")
    if len(in_spec) and in_spec[0] is not None:
        raise ValueError("microbatch axis of in_spec must be unsharded")
    layers_per_stage = n_layers // n_stages
    n_ticks = n_micro + n_stages - 1
    perm = [(s, (s + 1) % n_stages) for s in range(n_stages)]

    def fwd(params, x):
        """Pipelined forward: layer-stacked ``params``, microbatched ``x``."""
        if x.shape[0] != n_micro:
            raise ValueError(f"x leading axis {x.shape[0]} != n_micro="
                             f"{n_micro}")
        stages = mesh.banks(PP_AXIS)      # the stages this process runs
        outputs = torch.zeros((len(stages), *x.shape), dtype=x.dtype,
                              device=x.device)
        carry = torch.zeros((len(stages), *x.shape[1:]), dtype=x.dtype,
                            device=x.device)
        for tick in range(n_ticks):
            ys = []
            for j, stage in enumerate(stages):
                # Stage 0 feeds itself from the microbatch stream; later
                # stages consume the activation rotated in from the
                # previous stage.
                feed = x[tick] if tick < n_micro else carry[j]
                y = feed if stage == 0 else carry[j]
                for layer in range(layers_per_stage):
                    y = block_apply(
                        _layer(params, stage * layers_per_stage + layer), y)
                ys.append(y)
            out_idx = tick - (n_stages - 1)   # microbatch the LAST stage did
            if 0 <= out_idx < n_micro:
                for j, y in enumerate(ys):
                    outputs[j, out_idx] = y
            if tick != n_ticks - 1:
                carry = mesh.ppermute(torch.stack(ys), PP_AXIS, perm)
        return mesh.all_gather(outputs, PP_AXIS, dim=0, tiled=True)[0]

    return fwd
