"""Train step: loss, grads, optimizer application, and the compressed
cross-pod gradient all-reduce variant.

Port of :mod:`repro.train.train_step` on one device, or one pod a rank.

Baseline path (:func:`make_train_step`): the loss and its gradients by
autograd, then :func:`repro_torch.train.optimizer.apply`.

Compressed path (:func:`make_train_step_compressed`, a mesh with a
``pod`` axis): each pod computes the gradients of its contiguous slice of
the batch, int8-quantizes them against the shared error-feedback buffer
and sums the int8 codes across pods (an int8 all-reduce on a
:class:`~repro_torch.dist.ProcessGroupMesh`), with the quantization error
recycled into the next step.  On a :class:`~repro_torch.dist.LocalMesh`
the pods run one after the other on one device, and their gradients are
stacked one leaf at a time.

Data-parallel path (:class:`ShardedTrainStep`, ``make_train_step(...,
mesh, rules)`` with an ``fsdp`` axis wider than 1): the batch split over
the dp axes, the slices' gradients summed over them, and the optimizer
state sharded over ``fsdp`` by :func:`state_specs` (ZeRO-1), which the
reference gets from GSPMD.

A step updates its state in place and returns it: at full width the
state fills most of the card and cannot be held twice.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt

AUX_LOSS_WEIGHT = 0.01
POD_AXIS = "pod"


@dataclasses.dataclass
class TrainState:
    params: Any             # transformer.LM, requires_grad on
    opt: opt.OptState
    step: torch.Tensor
    ef: Any = None          # error-feedback buffers (compressed mode only)


def init_state(cfg: ModelCfg, generator: torch.Generator,
               compressed: bool = False) -> TrainState:
    """Weights drawn from ``generator`` onto its device (as
    :func:`~repro_torch.models.transformer.init_params`), with gradients
    on, their optimizer state, step 0 and, when ``compressed``, zero
    error-feedback buffers."""
    params = transformer.init_params(cfg, generator)
    params.requires_grad_(True)
    ef = opt.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params) if compressed else None
    return TrainState(params=params, opt=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=generator.device), ef=ef)


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def state_specs(cfg: ModelCfg, rules, compressed: bool = False
                ) -> TrainState:
    """The reference's spec tree of a :class:`TrainState`: the weights by
    ``param_specs``, the optimizer state by the ``for_opt=True`` specs
    (finer than the weights' under ``moe_zero1``), the step replicated
    and, when ``compressed``, the EF buffers as the weights."""
    pspecs = transformer.param_specs(cfg, rules)
    ospecs = transformer.param_specs(cfg, rules, for_opt=True)
    return TrainState(params=pspecs, opt=opt.state_specs(ospecs), step=(),
                      ef=copy.deepcopy(pspecs) if compressed else None)


def _nll(params, cfg: ModelCfg, batch, mesh=None):
    """(sum of the masked next-token NLL, sum of the mask, aux loss)."""
    logits, aux = transformer.forward(params, cfg, batch["tokens"],
                                      batch.get("embeds"), mesh)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    # stub-frontend prefixes are not scored
    prefix = logits.shape[1] - labels.shape[1]
    logits = logits[:, prefix:].float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    mask = batch.get("mask")
    mask = (torch.ones_like(nll) if mask is None
            else torch.as_tensor(mask, device=nll.device))
    return torch.sum(nll * mask), torch.sum(mask), aux


def loss_fn(params, cfg: ModelCfg, batch,
            mesh=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (fp32 logits path), plus the aux loss.

    ``batch["embeds"]``, where present, is a stub frontend's prefix; its
    positions are not scored.  ``mesh`` goes to the forward (the MoE
    layers of an ``ep`` config run expert-parallel on it).

    Returns (loss + AUX_LOSS_WEIGHT * aux, metrics); metrics ``loss``,
    ``aux`` and ``tokens`` are 0-d tensors.
    """
    nll_sum, tokens, aux = _nll(params, cfg, batch, mesh)
    loss = nll_sum / torch.clamp(tokens, min=1.0)
    metrics = {"loss": loss.detach(), "aux": aux.detach(), "tokens": tokens}
    return loss + AUX_LOSS_WEIGHT * aux, metrics


def _grads(params, cfg: ModelCfg, batch, mesh=None):
    """(gradients as the list of ``params``' leaves, metrics)."""
    total, metrics = loss_fn(params, cfg, batch, mesh)
    grads = torch.autograd.grad(total, opt.tree_leaves(params))
    return list(grads), metrics


def _update(opt_cfg: opt.OptCfg, state: TrainState, grads, metrics):
    _, state.opt, stats = opt.apply(opt_cfg, state.opt, grads, state.params)
    metrics.update(stats)
    state.step.add_(1)
    return state, metrics


class TrainStep:
    """``(state, batch) -> (state, metrics)``, in two halves that a caller
    may also run apart (to time them): :meth:`grads` and :meth:`update`."""

    def __init__(self, cfg: ModelCfg, opt_cfg: opt.OptCfg, mesh=None):
        self.cfg, self.opt_cfg, self.moe_mesh = cfg, opt_cfg, mesh

    def grads(self, state: TrainState, batch):
        """(gradients, metrics) of ``batch`` at ``state``'s weights."""
        return _grads(state.params, self.cfg,
                      to_device(batch, state.step.device), self.moe_mesh)

    def update(self, state: TrainState, grads, metrics):
        """Apply ``grads``: the state, updated in place, and the metrics
        with ``grad_norm`` and ``lr`` added."""
        return _update(self.opt_cfg, state, grads, metrics)

    def __call__(self, state: TrainState, batch):
        return self.update(state, *self.grads(state, batch))


class ShardedTrainStep(TrainStep):
    """The data-parallel step with the optimizer state sharded over the
    ``fsdp`` axis: what the reference's step does under GSPMD with its
    state laid out by :func:`state_specs`.

    :meth:`grads`: the batch splits into contiguous slices over
    ``rules.dp`` (slice ``i`` of ``n`` takes rows ``[i * b, (i + 1) *
    b)``, ``b`` the batch over ``n``, in row-major order of the dp axes as
    the mesh lists them).  Each held slice's gradients are those of
    ``nll_sum_i / T + AUX_LOSS_WEIGHT * aux_i / n``, ``T`` the whole
    batch's mask sum (at least 1), so their sum is the gradient of the
    reference's mean loss; the slices' gradients are summed in slice
    order (:meth:`_sum`), every rank ending with the whole sum.  The
    MoE aux loss is the mean of the slices' (the reference's is that of
    the whole batch), and a slice's forward takes no mesh: an ``ep``
    config's MoE layers run the dense path, since expert parallelism
    would split the batch over dp again.

    :meth:`update`: the state is sharded first (:meth:`shard_state`, by
    the ``for_opt=True`` specs, so ``moe_zero1`` keeps the ``data`` split
    on the state alone), then :func:`repro_torch.train.optimizer.apply`
    updates the held slices and gathers the weights.
    """

    def __init__(self, cfg: ModelCfg, opt_cfg: opt.OptCfg, mesh, rules):
        super().__init__(cfg, opt_cfg)
        self.mesh, self.rules = mesh, rules
        self.opt_specs = transformer.param_specs(cfg, rules, for_opt=True)
        self.dp = tuple(a for a in mesh.axis_names if a in (rules.dp or ()))

    def shard_state(self, state: TrainState) -> TrainState:
        """``state`` with its optimizer state sharded over ``fsdp`` (in
        place; a sharded state is left as it is)."""
        state.opt = opt.shard(state.opt, state.params, self.opt_specs,
                              self.mesh, self.rules.fsdp)
        return state

    def _held(self) -> list[int]:
        """The dp slices this process computes, by row-major position."""
        held = [0]
        for a in self.dp:
            held = [h * self.mesh.shape[a] + c for h in held
                    for c in self.mesh.banks(a)]
        return held

    def _sum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum over every dp slice of a value each held slice gave:
        accumulated in float32 in slice order, in the value's dtype.

        Where every slice is here (a :class:`~repro_torch.dist.LocalMesh`)
        that is a loop over them.  On a process-group mesh, where a rank
        holds one slice, it is a reduce-scatter and an all-gather: the
        flattened value is cut into one chunk per slice, chunk ``j`` of
        every rank goes to rank ``j`` (an all-to-all), which sums them in
        slice order, and the summed chunks are gathered.  Each rank sends
        and receives about twice the value's bytes, as an all-reduce, and
        the sum is elementwise the same as on a ``LocalMesh``.
        """
        n = self.mesh.width(self.dp)
        if len(parts) == n:
            if n == 1:
                return parts[0]
            acc = parts[0].to(torch.float32, copy=True)
            for x in parts[1:]:
                acc.add_(x)
            return acc.to(parts[0].dtype)
        (x,) = parts
        flat = x.reshape(-1)
        c = -(-flat.numel() // n)
        chunks = torch.cat([flat, flat.new_zeros(n * c - flat.numel())])
        recv = self.mesh.all_to_all(chunks.view(1, n, c), self.dp)[0]
        mine = self._sum(list(recv))
        return self.mesh.gather_batch(mine[None], self.dp).reshape(-1)[
            :flat.numel()].view(x.shape)

    def grads(self, state: TrainState, batch):
        """(the whole batch's gradients, the same on every rank, and its
        metrics)."""
        batch = to_device(batch, state.step.device)
        n = self.mesh.width(self.dp)
        rows = batch["labels"].shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split over "
                             f"{n} dp slices")
        part = rows // n
        mask = batch.get("mask")
        whole = (torch.sum(mask.float()) if mask is not None
                 else torch.tensor(float(batch["labels"].numel()),
                                   device=state.step.device))
        denom = torch.clamp(whole, min=1.0)
        leaves = opt.tree_leaves(state.params)
        per_slice, sums = [], []
        for i in self._held():
            sub = {k: v[i * part:(i + 1) * part] for k, v in batch.items()}
            nll_sum, tokens, aux = _nll(state.params, self.cfg, sub)
            total = nll_sum / denom + AUX_LOSS_WEIGHT * aux / n
            per_slice.append(list(torch.autograd.grad(total, leaves)))
            sums.append(torch.stack([nll_sum.detach(), tokens.float(),
                                     aux.detach()]))
        grads = []
        for j in range(len(leaves)):
            grads.append(self._sum([g[j] for g in per_slice]))
            for g in per_slice:
                g[j] = None
        nll_sum, tokens, aux = self._sum(sums)
        return grads, {"loss": nll_sum / denom, "aux": aux / n,
                       "tokens": tokens}

    def update(self, state: TrainState, grads, metrics):
        return _update(self.opt_cfg, self.shard_state(state), grads,
                       metrics)


def make_train_step(cfg: ModelCfg, opt_cfg: opt.OptCfg = opt.OptCfg(),
                    mesh=None, rules=None) -> TrainStep:
    """Train step: (state, batch) -> (state, metrics).

    ``mesh`` goes to the forward, as the reference's step passes its
    mesh: an ``ep`` config's MoE layers run expert-parallel on its
    ``model`` axis.  ``rules`` (:func:`repro_torch.dist.specs.make_rules`
    on ``mesh``): where ``rules.fsdp`` names an axis of ``mesh`` wider
    than 1, the step is a :class:`ShardedTrainStep` (the batch split over
    ``rules.dp``, the optimizer state over ``rules.fsdp``); else it is the
    one-device step.
    """
    if rules is not None and rules.fsdp is not None:
        if mesh is None:
            raise ValueError("rules with an fsdp axis need their mesh")
        if mesh.shape.get(rules.fsdp, 1) > 1:
            return ShardedTrainStep(cfg, opt_cfg, mesh, rules)
    return TrainStep(cfg, opt_cfg, mesh)


class CompressedTrainStep(TrainStep):
    """The compressed step, in three parts: :meth:`grads` (each held pod's
    gradients of its batch slice), :meth:`reduce` (quantize, sum the int8
    codes across pods, share the error feedback) and :meth:`update`."""

    def __init__(self, cfg: ModelCfg, mesh, opt_cfg: opt.OptCfg):
        if POD_AXIS not in mesh.axis_names:
            raise ValueError(f"compressed DP needs a {POD_AXIS!r} axis; "
                             f"mesh axes {mesh.axis_names}")
        super().__init__(cfg, opt_cfg)
        self.mesh = mesh
        self.n_pods = mesh.shape[POD_AXIS]
        self.levels = max(127 // self.n_pods, 1)

    def grads(self, state: TrainState, batch):
        """([per held pod: its gradient list], [its metrics]).  Pod ``c``
        takes rows ``[c * b, (c + 1) * b)`` of the batch, ``b`` the batch
        over the pod count."""
        batch = to_device(batch, state.step.device)
        rows = next(iter(batch.values())).shape[0]
        if rows % self.n_pods:
            raise ValueError(f"batch of {rows} rows does not split over "
                             f"{self.n_pods} pods")
        part = rows // self.n_pods
        out = [_grads(state.params, self.cfg,
                      {k: v[c * part:(c + 1) * part]
                       for k, v in batch.items()})
               for c in self.mesh.banks(POD_AXIS)]
        return [g for g, _ in out], [m for _, m in out]

    def _pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather(x, POD_AXIS).amax(dim=1)

    def _pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(x, POD_AXIS) / self.n_pods

    def reduce(self, state: TrainState, pod_grads, pod_metrics):
        """(mean gradients, pod-mean metrics); the EF buffers of ``state``
        are updated in place.

        Leaf by leaf of the reference's tree (one scale for all layers of
        a stacked leaf, as the reference's): the held pods' gradients
        stacked, plus the shared EF; ``scale = pmax(max|g + ef|) / levels
        + 1e-12``; codes clipped to +-levels and summed across pods as
        int8; the new EF is the pod mean of each pod's quantization error.
        """
        index = {id(x): i for i, x in
                 enumerate(opt.tree_leaves(state.params))}
        mean = [None] * len(index)
        for (ps, _), (efs, _) in zip(opt.groups(state.params),
                                     opt.groups(state.ef), strict=True):
            idx = [index[id(p)] for p in ps]
            gcs = []
            for i, e in zip(idx, efs):
                g = torch.stack([grads[i] for grads in pod_grads])
                for grads in pod_grads:
                    grads[i] = None
                gcs.append(g.float() + e)
                del g
            amax = torch.stack([gc.reshape(gc.shape[0], -1).abs().amax(dim=1)
                                for gc in gcs]).amax(dim=0)
            scale = self._pmax(amax / self.levels + 1e-12)
            for i, e, gc in zip(idx, efs, gcs):
                s = scale.reshape((1,) * gc.ndim)
                q = torch.clamp(torch.round(gc / s), -self.levels,
                                self.levels).to(torch.int8)
                total = self.mesh.psum(q, POD_AXIS)   # int8 on the wire
                mean[i] = (total.float() * s / self.n_pods)[0]
                e.copy_(self._pmean(gc - q.float() * s)[0])
        metrics = {k: self._pmean(torch.stack([m[k] for m in pod_metrics]))[0]
                   for k in pod_metrics[0]}
        return mean, metrics

    def __call__(self, state: TrainState, batch):
        return self.update(state, *self.reduce(state,
                                               *self.grads(state, batch)))


def make_train_step_compressed(cfg: ModelCfg, mesh,
                               opt_cfg: opt.OptCfg = opt.OptCfg()
                               ) -> CompressedTrainStep:
    """Hierarchical DP: per-pod grads, int8+EF sum across pods.

    Requires a mesh with a ``pod`` axis.  Per-pod codes are clipped to
    +-(127 // n_pods) so the elementwise int8 sum cannot overflow; the
    state needs EF buffers (``init_state(..., compressed=True)``).
    """
    return CompressedTrainStep(cfg, mesh, opt_cfg)
