"""Decoder assembly for the dense family: embeddings, blocks, forward
(train/prefill) and decode steps.

Port of :mod:`repro.models.transformer` for ``"attn"`` blocks with a dense
SwiGLU MLP, on one device.  The reference stacks a uniform stack on a
leading L axis and scans it; here the layers are an ``nn.ModuleList``
walked by a Python loop, and only the decode cache keeps the stacked
(L, ...) layout (a training checkpoint stacks the layers on the host, see
:mod:`repro_torch.checkpoint.checkpointer`).  The other block kinds, MoE,
MLA and the stub frontends raise :class:`NotImplementedError` naming the
ROADMAP item that ports them.

``forward`` is differentiable: parameters are frozen as they are made, so
serving builds no autograd graph, and training turns ``requires_grad`` on
for its own weights (:func:`repro_torch.train.train_step.init_state`).
With ``cfg.parallel.remat == "block"`` each layer is recomputed in the
backward pass, as the reference wraps each layer in ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.configs.base import ModelCfg
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; it comes with the model "
        f"families of ROADMAP Queue 1 item 11b (only dense 'attn' blocks "
        f"with a SwiGLU MLP are ported)")


def check_supported(cfg: ModelCfg) -> None:
    """Raise :class:`NotImplementedError` unless ``cfg`` is in the dense
    family this port covers."""
    kinds = set(cfg.block_pattern)
    if kinds != {"attn"}:
        raise _not_ported(f"block kinds {sorted(kinds - {'attn'})}"
                          if kinds - {"attn"} else "this block pattern")
    if cfg.moe is not None:
        raise _not_ported("the MoE block")
    if cfg.mla is not None:
        raise _not_ported("MLA attention")
    if cfg.frontend is not None:
        raise _not_ported(f"the {cfg.frontend} stub frontend")


def model_dtype(cfg: ModelCfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Block(nn.Module):
    """One ``"attn"`` block: ``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg: ModelCfg, dtype, device=None):
        super().__init__()
        self.norm1 = layers.RMSNorm(cfg.d_model, device)
        self.attn = attention.Attention(cfg, dtype, device)
        self.norm2 = layers.RMSNorm(cfg.d_model, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)


class LM(nn.Module):
    """Parameters of the decoder: ``embed`` (vocab_padded, d), ``blocks``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (d,
    vocab_padded).  Allocated uninitialised: :func:`init_params` draws
    them, :func:`repro_torch.convert.lm_params_from_numpy` copies them in.
    ``dtype`` (default the config's) is that of every weight but the
    float32 norm scales; the optimizer's float32 copies are LMs too.
    """

    def __init__(self, cfg: ModelCfg, device=None, dtype=None):
        super().__init__()
        check_supported(cfg)
        dtype = model_dtype(cfg) if dtype is None else dtype
        kw = {"dtype": dtype, "device": device}
        self.embed = layers.frozen(torch.empty(
            (cfg.vocab_padded, cfg.d_model), **kw))
        self.final_norm = layers.RMSNorm(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = layers.frozen(torch.empty(
                (cfg.d_model, cfg.vocab_padded), **kw))
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        # the reference stacks a scanned uniform stack on a leading L axis
        self.stacked = cfg.scan_layers and cfg.uniform_pattern

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reference_tree(self) -> dict:
        """The reference's parameter tree of this LM, holding its tensors
        (no copies): ``{"embed", "final_norm": {"scale"}, "blocks"}`` (and
        ``"lm_head"``), the blocks of a scanned uniform stack as
        :class:`~repro_torch.models.layers.LayerStack` leaves
        (``blocks["attn"]["wq"]`` the layers' ``wq``), else a list of
        per-layer trees."""
        own = dict(self.named_parameters())
        tree = _nest({n: x for n, x in own.items()
                      if not n.startswith("blocks.")})
        per_layer = [dict(b.named_parameters()) for b in self.blocks]
        if self.stacked:
            tree["blocks"] = _nest({
                n: layers.LayerStack(layer[n] for layer in per_layer)
                for n in per_layer[0]})
        else:
            tree["blocks"] = [_nest(layer) for layer in per_layer]
        return tree

    def with_reference_tree(self, tree: dict) -> "LM":
        """An LM of this one's structure holding the tensors of ``tree``
        (shaped as :meth:`reference_tree` gives it)."""
        flat = dict(_dotted({k: v for k, v in tree.items()
                             if k != "blocks"}))
        blocks = tree["blocks"]
        if isinstance(blocks, dict):
            for name, stack in _dotted(blocks):
                for i, x in enumerate(stack.parts):
                    flat[f"blocks.{i}.{name}"] = x
        else:
            for i, layer in enumerate(blocks):
                flat.update((f"blocks.{i}.{n}", x)
                            for n, x in _dotted(layer))
        return layers.module_like(self, flat)


def _nest(flat: dict) -> dict:
    """``{"attn.wq": x}`` -> ``{"attn": {"wq": x}}``."""
    out: dict = {}
    for name, x in flat.items():
        *heads, last = name.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = x
    return out


def _dotted(tree: dict, prefix: str = ""):
    """The inverse of :func:`_nest`: (dotted name, leaf) pairs."""
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _dotted(x, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", x


def init_params(cfg: ModelCfg, generator: torch.Generator) -> LM:
    """A randomly initialised :class:`LM`, drawn from ``generator`` onto its
    device.  The draws follow the reference's distributions, not its JAX
    key stream.
    """
    dev = generator.device
    dtype = model_dtype(cfg)
    p = LM(cfg, dev)
    p.embed.copy_(layers.embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                    dtype, dev))
    if not cfg.tie_embeddings:
        p.lm_head.copy_(layers.dense_init(generator, cfg.d_model,
                                          cfg.vocab_padded, dtype, dev))
    for blk in p.blocks:
        blk.attn = attention.init(generator, cfg, dtype, dev)
        blk.mlp = layers.mlp_init(generator, cfg.d_model, cfg.d_ff, dtype,
                                  dev)
    return p


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_apply(p: Block, x: torch.Tensor, cfg: ModelCfg,
                 positions: torch.Tensor) -> torch.Tensor:
    h = layers.rmsnorm(p.norm1, x, cfg.norm_eps)
    x = x + attention.full_attention(p.attn, h, cfg, positions)
    h2 = layers.rmsnorm(p.norm2, x, cfg.norm_eps)
    return x + layers.mlp(p.mlp, h2)


def _head(params: LM, cfg: ModelCfg) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def forward(params: LM, cfg: ModelCfg, tokens) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Full forward pass -> (logits (B,S,vocab_padded), aux loss scalar).

    The dense family has no auxiliary loss: aux is a float32 zero.  Where
    grad is enabled and ``cfg.parallel.remat == "block"``, each layer's
    activations are recomputed in the backward pass.
    """
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = params.embed[tokens].to(model_dtype(cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.parallel.remat == "block" and torch.is_grad_enabled()
    for blk in params.blocks:
        if remat:
            x = _checkpoint.checkpoint(_block_apply, blk, x, cfg, positions,
                                       use_reentrant=False)
        else:
            x = _block_apply(blk, x, cfg, positions)
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = x @ _head(params, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode (one token, stateful caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelCfg, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    """Per-layer KV cache, stacked as the reference stacks a uniform stack:
    ``{"k": (L, B, T, HK, dh), "v": ...}``, zeros of ``dtype`` (bf16 by
    default, whatever the model's dtype) on ``device`` (default the GPU).
    """
    check_supported(cfg)
    k_shp, v_shp = attention.cache_shape(cfg, batch, max_len)
    dev = resolve_device(device)
    return {"k": torch.zeros((cfg.n_layers, *k_shp), dtype=dtype, device=dev),
            "v": torch.zeros((cfg.n_layers, *v_shp), dtype=dtype, device=dev)}


def _block_decode(p: Block, x, layer_cache: tuple, pos, cfg: ModelCfg,
                  active=None):
    h = layers.rmsnorm(p.norm1, x, cfg.norm_eps)
    a, _ = attention.decode_attention(p.attn, h, layer_cache, pos, cfg,
                                      active=active)
    x = x + a
    h2 = layers.rmsnorm(p.norm2, x, cfg.norm_eps)
    return x + layers.mlp(p.mlp, h2)


@torch.no_grad()
def decode_step(params: LM, cfg: ModelCfg, cache: dict[str, torch.Tensor],
                tokens, pos, active=None) -> tuple[torch.Tensor, Any]:
    """One serving step: tokens (B, 1) + caches at ``pos`` (scalar or (B,)
    per-slot positions) -> (logits (B, 1, vocab_padded), cache).
    ``active``: (B,) bool continuous-batching mask; inactive slots leave the
    cache untouched.  The cache is updated in place and returned.
    """
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = params.embed[tokens].to(model_dtype(cfg))
    for i, blk in enumerate(params.blocks):
        x = _block_decode(blk, x, (cache["k"][i], cache["v"][i]), pos, cfg,
                          active)
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return x @ _head(params, cfg), cache
