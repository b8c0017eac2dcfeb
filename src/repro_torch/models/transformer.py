"""Decoder assembly for all ten architectures: embeddings, block dispatch,
forward (train/prefill) and decode steps.

Port of :mod:`repro.models.transformer` on one device.  A block is one of
five kinds (``cfg.block_kind(i)``): ``"attn"`` / ``"local"`` (GQA or MLA
attention, then an MoE or a SwiGLU MLP), ``"rglru"``, ``"mlstm"`` and
``"slstm"``, with the reference's parameter names (``norm1``, ``attn``,
``norm2``, ``mlp`` / ``moe``, ``rec``, ``xl``).  The reference stacks a
uniform stack on a leading L axis and scans it; here the layers are an
``nn.ModuleList`` walked by a Python loop, and only the decode cache of a
uniform stack keeps the stacked (L, ...) layout (a training checkpoint
stacks the layers on the host, see
:mod:`repro_torch.checkpoint.checkpointer`).  Heterogeneous stacks (the
hybrid and xLSTM patterns) are lists of per-layer trees in
:meth:`LM.reference_tree` and per-layer dicts in the cache, as in the
reference.

The audio and vision frontends are stubs, as in the reference: the model
takes (B, P, 1024) precomputed frame or patch embeddings, and a learned
``frontend_proj`` folds them into the token stream as a prefix.

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
from repro_torch.models import attention, layers, mla, moe, rglru, xlstm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KINDS = ("attn", "local", "rglru", "mlstm", "slstm")
STUB_FRONTEND_DIM = 1024   # precomputed frame/patch embedding width


def check_supported(cfg: ModelCfg) -> None:
    """Raise :class:`ValueError` unless every block kind of ``cfg`` is one
    of :data:`KINDS` (all ten architectures' are)."""
    unknown = set(cfg.block_pattern) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown block kinds {sorted(unknown)}")


def model_dtype(cfg: ModelCfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Block(nn.Module):
    """One block of kind ``kind``: ``norm1`` and, by kind, ``attn`` (MLA
    or GQA) + ``norm2`` + ``moe`` or ``mlp``; ``rec`` + ``norm2`` +
    ``mlp``; or ``xl`` (mLSTM / sLSTM)."""

    def __init__(self, cfg: ModelCfg, kind: str, dtype, device=None):
        super().__init__()
        self.norm1 = layers.RMSNorm(cfg.d_model, device)
        if kind in ("attn", "local"):
            self.attn = (mla.MLA(cfg, dtype, device) if cfg.mla is not None
                         else attention.Attention(cfg, dtype, device))
            self.norm2 = layers.RMSNorm(cfg.d_model, device)
            if cfg.moe is not None:
                self.moe = moe.MoE(cfg, dtype, device)
            else:
                self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)
        elif kind == "rglru":
            self.rec = rglru.RGLRU(cfg, dtype, device)
            self.norm2 = layers.RMSNorm(cfg.d_model, device)
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)
        elif kind == "mlstm":
            self.xl = xlstm.MLSTM(cfg, dtype, device)
        elif kind == "slstm":
            self.xl = xlstm.SLSTM(cfg, dtype, device)
        else:
            raise ValueError(kind)


def _block_init(generator, cfg: ModelCfg, kind: str, blk: Block, dtype,
                device) -> None:
    """Draw ``blk``'s weights (its norms stay ones)."""
    if kind in ("attn", "local"):
        blk.attn = (mla.init(generator, cfg, dtype, device)
                    if cfg.mla is not None
                    else attention.init(generator, cfg, dtype, device))
        if cfg.moe is not None:
            blk.moe = moe.init(generator, cfg, dtype, device)
        else:
            blk.mlp = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                      dtype, device)
    elif kind == "rglru":
        blk.rec = rglru.init(generator, cfg, dtype, device)
        blk.mlp = layers.mlp_init(generator, cfg.d_model, cfg.d_ff, dtype,
                                  device)
    elif kind == "mlstm":
        blk.xl = xlstm.mlstm_init(generator, cfg, dtype, device)
    else:
        blk.xl = xlstm.slstm_init(generator, cfg, dtype, device)


class LM(nn.Module):
    """Parameters of the decoder: ``embed`` (vocab_padded, d), ``blocks``,
    ``final_norm``, without tied embeddings ``lm_head`` (d, vocab_padded)
    and, with a stub frontend, ``frontend_proj`` (1024, d).  Allocated
    uninitialised: :func:`init_params` draws them,
    :func:`repro_torch.convert.lm_params_from_numpy` copies them in.
    ``dtype`` (default the config's) is that of every weight but the
    float32 leaves the reference keeps in float32 (norm scales, the MoE
    router, the recurrent gates' biases and ``lam``, the mLSTM gate
    weights); the optimizer's float32 copies are LMs too.
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
        if cfg.frontend is not None:
            self.frontend_proj = layers.frozen(torch.empty(
                (STUB_FRONTEND_DIM, cfg.d_model), **kw))
        self.blocks = nn.ModuleList(Block(cfg, cfg.block_kind(i), dtype,
                                          device)
                                    for i in range(cfg.n_layers))
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


# ---------------------------------------------------------------------------
# Sharding specs (tuples of mesh axis names, see repro_torch.dist.specs)
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelCfg, kind: str, rules,
                 for_opt: bool = False) -> dict:
    """Weight specs of one block of kind ``kind``, keyed as its parameters."""
    s: dict[str, Any] = {"norm1": {"scale": (None,)}}
    if kind in ("attn", "local"):
        s["attn"] = (mla.specs(rules) if cfg.mla is not None
                     else attention.specs(rules))
        s["norm2"] = {"scale": (None,)}
        if cfg.moe is not None:
            s["moe"] = moe.specs(cfg, rules, for_opt=for_opt)
        else:
            s["mlp"] = layers.mlp_specs(rules)
    elif kind == "rglru":
        s["rec"] = rglru.specs(rules)
        s["norm2"] = {"scale": (None,)}
        s["mlp"] = layers.mlp_specs(rules)
    elif kind in ("mlstm", "slstm"):
        s["xl"] = (xlstm.mlstm_specs(rules) if kind == "mlstm"
                   else xlstm.slstm_specs(rules))
    return s


def _stack_specs(tree):
    """A spec tree with a leading replicated entry (the layer axis) on each
    spec, as the reference's scanned stack carries it."""
    if isinstance(tree, dict):
        return {k: _stack_specs(v) for k, v in tree.items()}
    return (None, *tree)


def param_specs(cfg: ModelCfg, rules, for_opt: bool = False) -> dict:
    """The reference's spec tree of the parameters: the tree of
    :meth:`LM.reference_tree`, each leaf a spec tuple.  A scanned uniform
    stack's blocks are one dict whose specs lead with ``None`` (the
    layer axis); a heterogeneous stack's are a list of per-layer dicts.
    ``for_opt`` gives the optimizer state's specs (they differ from the
    weights' under ``moe_zero1``).  :func:`repro_torch.train.optimizer.
    leaf_specs` maps the tree onto the LM's per-layer parameters."""
    s: dict[str, Any] = {"embed": rules.embed(),
                         "final_norm": {"scale": (None,)}}
    if not cfg.tie_embeddings:
        s["lm_head"] = (rules.fsdp, rules.tp)
    if cfg.frontend is not None:
        s["frontend_proj"] = (None, None)
    if cfg.scan_layers and cfg.uniform_pattern:
        s["blocks"] = _stack_specs(_block_specs(cfg, cfg.block_pattern[0],
                                                rules, for_opt))
    else:
        s["blocks"] = [_block_specs(cfg, cfg.block_kind(i), rules, for_opt)
                       for i in range(cfg.n_layers)]
    return s


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
    if cfg.frontend is not None:
        p.frontend_proj.copy_(layers.dense_init(
            generator, STUB_FRONTEND_DIM, cfg.d_model, dtype, dev))
    for i, blk in enumerate(p.blocks):
        _block_init(generator, cfg, cfg.block_kind(i), blk, dtype, dev)
    return p


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_apply(p: Block, x: torch.Tensor, cfg: ModelCfg,
                 positions: torch.Tensor, kind: str = "attn", mesh=None):
    """One block over (B, S, D) -> (residual-updated x, aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(p.norm1, x, cfg.norm_eps)
    if kind in ("attn", "local"):
        if cfg.mla is not None:
            a = mla.full_attention(p.attn, h, cfg, positions)
        elif kind == "local":
            a = attention.local_attention(p.attn, h, cfg, positions)
        else:
            a = attention.full_attention(p.attn, h, cfg, positions)
        x = x + a
        h2 = layers.rmsnorm(p.norm2, x, cfg.norm_eps)
        if cfg.moe is not None:
            f, aux = moe.moe_block(p.moe, h2, cfg, mesh)
        else:
            f = layers.mlp(p.mlp, h2)
        x = x + f
    elif kind == "rglru":
        x = x + rglru.block(p.rec, h, cfg)
        h2 = layers.rmsnorm(p.norm2, x, cfg.norm_eps)
        x = x + layers.mlp(p.mlp, h2)
    elif kind == "mlstm":
        x = x + xlstm.mlstm_block(p.xl, h, cfg)
    elif kind == "slstm":
        x = x + xlstm.slstm_block(p.xl, h, cfg)
    else:
        raise ValueError(kind)
    return x, aux


def _head(params: LM, cfg: ModelCfg) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _embed_inputs(params: LM, cfg: ModelCfg, tokens, embeds):
    """tokens (B,S_tok) [+ embeds (B,P,1024) for stub frontends] -> (B,S,D)
    activations, the prefix's projection first."""
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = params.embed[tokens].to(model_dtype(cfg))
    if cfg.frontend is not None:
        if embeds is None:
            raise ValueError(f"the {cfg.frontend} stub frontend of "
                             f"{cfg.name} needs embeds (B, P, "
                             f"{STUB_FRONTEND_DIM})")
        embeds = torch.as_tensor(embeds, device=params.device)
        prefix = embeds.to(x.dtype) @ params.frontend_proj
        x = torch.cat([prefix, x], dim=1)
    return x


def forward(params: LM, cfg: ModelCfg, tokens, embeds=None,
            mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass -> (logits (B,S,vocab_padded), aux loss scalar).

    ``embeds`` (B, P, 1024): the stub frontend's prefix, which a frontend
    architecture needs (its logits cover the P prefix positions too).
    ``mesh``: the MoE layers of an ``ep`` config run expert-parallel over
    its ``model`` axis (:func:`repro_torch.models.moe.moe_ep`), else the
    dense oracle.  aux is the MoE load-balance losses summed over the
    layers (a float32 zero without MoE).  Where grad is enabled and
    ``cfg.parallel.remat == "block"``, each layer's activations are
    recomputed in the backward pass.
    """
    x = _embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = cfg.parallel.remat == "block" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(params.blocks):
        kind = cfg.block_kind(i)
        if remat:
            x, a = _checkpoint.checkpoint(_block_apply, blk, x, cfg,
                                          positions, kind, mesh,
                                          use_reentrant=False)
        else:
            x, a = _block_apply(blk, x, cfg, positions, kind, mesh)
        aux = aux + a
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return x @ _head(params, cfg), aux


# ---------------------------------------------------------------------------
# Decode (one token, stateful caches)
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelCfg, kind: str, batch: int, max_len: int, dtype,
                 dev, lead: tuple = ()) -> dict:
    """Zero decode state of one layer (or of ``lead`` stacked layers)."""
    f32 = torch.float32

    def zeros(shp, dt=dtype):
        return torch.zeros((*lead, *shp), dtype=dt, device=dev)

    if kind in ("attn", "local"):
        if cfg.mla is not None:
            c_shp, r_shp = mla.cache_shape(cfg, batch, max_len)
            return {"c_kv": zeros(c_shp), "k_rope": zeros(r_shp)}
        k_shp, v_shp = attention.cache_shape(cfg, batch, max_len,
                                             local=(kind == "local"))
        return {"k": zeros(k_shp), "v": zeros(v_shp)}
    if kind == "rglru":
        shp = rglru.state_shape(cfg, batch)
        return {"h": zeros(shp["h"], f32), "conv": zeros(shp["conv"])}
    if kind == "mlstm":
        shp = xlstm.mlstm_state_shape(cfg, batch)
        return {"c": zeros(shp["c"], f32), "n": zeros(shp["n"], f32),
                "m": zeros(shp["m"], f32).fill_(-1e30),
                "conv": zeros(shp["conv"])}
    if kind == "slstm":
        shp = xlstm.slstm_state_shape(cfg, batch)
        return {"c": zeros(shp["c"], f32), "n": zeros(shp["n"], f32),
                "m": zeros(shp["m"], f32).fill_(-1e30)}
    raise ValueError(kind)


def init_cache(cfg: ModelCfg, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Any:
    """Per-layer decode state on ``device`` (default the GPU), structured
    as the reference's: a uniform scanned stack stacks each tensor on a
    leading L axis (``{"k", "v"}`` or, for MLA, ``{"c_kv", "k_rope"}``,
    each (L, B, T, ...)); a heterogeneous stack is a list of per-layer
    dicts.  Caches and convolution states are zeros of ``dtype`` (bf16 by
    default, whatever the model's dtype); recurrent states are float32,
    their running maxima ``m`` filled with -1e30.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    if cfg.scan_layers and cfg.uniform_pattern:
        return _layer_cache(cfg, cfg.block_pattern[0], batch, max_len,
                            dtype, dev, lead=(cfg.n_layers,))
    return [_layer_cache(cfg, cfg.block_kind(i), batch, max_len, dtype, dev)
            for i in range(cfg.n_layers)]


def cache_specs(cfg: ModelCfg, rules) -> Any:
    """The reference's spec tree of :func:`init_cache`'s cache: B on dp,
    the head or state width on tp (or the sequence, under cp), a leading
    ``None`` on a stacked uniform cache."""
    def one_layer(kind: str, stacked: bool) -> dict:
        lead = (None,) if stacked else ()
        dp, tp = rules.dp, rules.tp
        if kind in ("attn", "local"):
            if cfg.mla is not None:
                return {"c_kv": (*lead, dp, tp, None),
                        "k_rope": (*lead, dp, tp, None)}
            spec = attention._cache_spec(rules)
            return {"k": (*lead, *spec), "v": (*lead, *spec)}
        if kind == "rglru":
            return {"h": (*lead, dp, tp), "conv": (*lead, dp, None, tp)}
        if kind == "mlstm":
            return {"c": (*lead, dp, None, None, None),
                    "n": (*lead, dp, None, None), "m": (*lead, dp, None),
                    "conv": (*lead, dp, None, tp)}
        if kind == "slstm":
            return {"c": (*lead, dp, None), "n": (*lead, dp, None),
                    "m": (*lead, dp, None)}
        raise ValueError(kind)

    if cfg.scan_layers and cfg.uniform_pattern:
        return one_layer(cfg.block_pattern[0], True)
    return [one_layer(cfg.block_kind(i), False) for i in range(cfg.n_layers)]


def _block_decode(p: Block, x, cache: dict, pos, kind: str, cfg: ModelCfg,
                  active=None, mesh=None):
    """One block's decode step; ``cache`` (this layer's dict of tensors) is
    updated in place.  A recurrent block keeps the state of inactive
    slots, as the reference freezes it."""
    h = layers.rmsnorm(p.norm1, x, cfg.norm_eps)
    if kind in ("attn", "local"):
        if cfg.mla is not None:
            a, _ = mla.decode_attention(p.attn, h, (cache["c_kv"],
                                                    cache["k_rope"]),
                                        pos, cfg, active=active)
        else:
            a, _ = attention.decode_attention(
                p.attn, h, (cache["k"], cache["v"]), pos, cfg,
                local=(kind == "local"), active=active)
        x = x + a
        h2 = layers.rmsnorm(p.norm2, x, cfg.norm_eps)
        if cfg.moe is not None:
            f, _ = moe.moe_block(p.moe, h2, cfg, mesh)
        else:
            f = layers.mlp(p.mlp, h2)
        return x + f
    if kind == "rglru":
        a, new = rglru.block_decode(p.rec, h, cache, cfg)
        x = x + a
        x = x + layers.mlp(p.mlp, layers.rmsnorm(p.norm2, x, cfg.norm_eps))
    elif kind == "mlstm":
        a, new = xlstm.mlstm_block_decode(p.xl, h, cache, cfg)
        x = x + a
    elif kind == "slstm":
        a, new = xlstm.slstm_block_decode(p.xl, h, cache, cfg)
        x = x + a
    else:
        raise ValueError(kind)
    for name, val in new.items():
        if active is not None:
            mask = torch.as_tensor(active, dtype=torch.bool,
                                   device=x.device)
            val = torch.where(mask.reshape((-1,) + (1,) * (val.ndim - 1)),
                              val, cache[name])
        cache[name].copy_(val)
    return x


@torch.no_grad()
def decode_step(params: LM, cfg: ModelCfg, cache, tokens, pos, active=None,
                mesh=None) -> tuple[torch.Tensor, Any]:
    """One serving step: tokens (B, 1) + caches at ``pos`` (scalar or (B,)
    per-slot positions) -> (logits (B, 1, vocab_padded), cache).
    ``active``: (B,) bool continuous-batching mask; inactive slots leave
    the cache and recurrent state untouched.  ``mesh``: as for
    :func:`forward`.  The cache (either structure of :func:`init_cache`)
    is updated in place and returned.
    """
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = params.embed[tokens].to(model_dtype(cfg))
    for i, blk in enumerate(params.blocks):
        if isinstance(cache, dict):                  # stacked (L, ...) views
            layer = {name: t[i] for name, t in cache.items()}
        else:
            layer = cache[i]
        x = _block_decode(blk, x, layer, pos, cfg.block_kind(i), cfg,
                          active, mesh)
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return x @ _head(params, cfg), cache
