"""AdamW with float32 master weights, and int8 gradient quantization.

Port of :mod:`repro.train.optimizer`.  The optimizer state mirrors the
parameter tree: ``master``, ``m`` and ``v`` hold a float32 tensor for every
parameter, in a tree of the parameters' structure.  A tree is an
``nn.Module`` (its ``named_parameters()``, in that order; the state's
copies are structural copies of the module, see
:func:`repro_torch.models.layers.module_like`), a dict (its keys in sorted
order, as JAX flattens one), a list or tuple, or a tensor.

The update acts on the leaves of the *reference's* tree: an LM's layers
are stacked there, so one leaf (a
:class:`~repro_torch.models.layers.LayerStack`) holds every layer's
tensor of one name and has one more dimension.  Weight decay goes to the
leaves with ``ndim >= 2`` as the reference counts them, which takes in
each layer's norm scales ((L, d) stacked) but not ``final_norm``'s (d,).

:func:`apply` updates the master weights, the moments and the parameters
in place and returns them: a model whose state fills most of the card
cannot be held twice.  It keeps the reference's order of operations, and
``count``, ``lr`` and ``grad_norm`` stay 0-d tensors on the parameters'
device, so an update never waits for the host.

``quantize_grad`` / ``dequantize_grad`` are the int8 error-feedback
compression of the compressed cross-pod step
(:func:`repro_torch.train.train_step.make_train_step_compressed`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


@dataclasses.dataclass
class OptState:
    master: Any     # fp32 master params
    m: Any          # first moment
    v: Any          # second moment
    count: torch.Tensor


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree in flattening order (``None`` holds none)."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def groups(tree, leaves=None) -> list[tuple[list[torch.Tensor], int]]:
    """The leaves of ``tree`` as the reference's tree holds them, in its
    order: (the tensors of the leaf, the leaf's ndim).  A tensor is a leaf
    of one part; a :class:`~repro_torch.models.layers.LayerStack` (an LM's
    :meth:`~repro_torch.models.transformer.LM.reference_tree`) one of a
    part per layer.  ``leaves``, aligned with :func:`tree_leaves`'s order
    of ``tree`` (gradients, say), are grouped in their place.
    """
    if leaves is not None:
        by_id = dict(zip(map(id, tree_leaves(tree)), leaves, strict=True))
        return [([by_id[id(x)] for x in parts], ndim)
                for parts, ndim in groups(tree)]
    if tree is None:
        return []
    if hasattr(tree, "reference_tree"):
        return groups(tree.reference_tree())
    if isinstance(tree, layers.LayerStack):
        return [(tree.parts, tree.ndim)]
    if isinstance(tree, nn.Module):
        return [([p], p.ndim) for p in tree.parameters()]
    if isinstance(tree, dict):
        return [g for k in sorted(tree) for g in groups(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [g for sub in tree for g in groups(sub)]
    return [([tree], tree.ndim)]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """A tree of ``tree``'s structure holding ``fn(leaf)`` for each leaf
    (a module's copy takes no gradients)."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        return layers.module_like(tree, {n: fn(p.detach()) for n, p
                                         in tree.named_parameters()}
                                  ).requires_grad_(False)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def init(params: Any) -> OptState:
    """float32 copies of the parameters, zero moments, count 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return OptState(
        master=tree_map(lambda p: p.to(torch.float32, copy=True), params),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: OptCfg, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(
        step < cfg.warmup_steps, 1.0, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    return _norm(groups(tree))


def _norm(grouped) -> torch.Tensor:
    total = sum(sum(torch.sum(torch.square(x.float())) for x in parts)
                for parts, _ in grouped)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as the reference's.  CUDA's is;
    PyTorch's vectorised CPU sqrt is one ulp off for about 0.6 % of
    float32 inputs, so the CPU takes it in float64 (exact after rounding
    back, since float64 carries more than twice float32's digits)."""
    return x.sqrt_() if x.is_cuda else x.double().sqrt_().float()


@torch.no_grad()
def apply(cfg: OptCfg, state: OptState, grads: Any, params: Any):
    """One AdamW step.  Returns (params, state, stats).

    ``grads`` is a tree of ``params``' structure, or the list of its
    leaves in :func:`tree_leaves` order.  The master weights, the moments
    and the parameters are updated in place (the returned ``state`` holds
    the same tensors and a new ``count``); the new parameters are the
    master weights cast to the parameters' dtype.  ``stats`` are 0-d
    tensors: ``grad_norm`` before clipping and the step's ``lr``.
    """
    flat = grads if isinstance(grads, list) else tree_leaves(grads)
    g_groups = groups(params, flat)
    gnorm = _norm(g_groups)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())

    for (gs, ndim), (ps, _), (masters, _), (ms, _), (vs, _) in zip(
            g_groups, groups(params), groups(state.master), groups(state.m),
            groups(state.v), strict=True):
        for g, master, m, v, p in zip(gs, masters, ms, vs, ps, strict=True):
            g = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step_ = (m / b1c).div_(_sqrt(v / b2c).add_(cfg.eps))
            # decoupled weight decay on matrices only (ndim >= 2)
            if ndim >= 2:
                step_.add_(cfg.weight_decay * master)
            master.sub_(lr * step_)
            p.copy_(master)
    return params, OptState(state.master, state.m, state.v, count), {
        "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def quantize_grad(g: torch.Tensor, ef: torch.Tensor):
    """g + error-feedback -> (int8 codes, scale, new error feedback)."""
    gc = g.float() + ef
    scale = torch.max(torch.abs(gc)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)
    new_ef = gc - q.float() * scale
    return q, scale, new_ef


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
