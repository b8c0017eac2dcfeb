"""Attention: GQA/MQA/MHA, full causal self-attention and cached decode.

Port of :mod:`repro.models.attention` on one device.  The reference's
sharding constraints are the identity there, so they fall away, and its
KV replication up to the tensor-parallel width reduces to the stored
``kv_replicate`` (:func:`_kv_rep`).  Attention math accumulates in float32;
masks fill with the finite -1e30.

``local_attention`` and the ring-buffer decode of local layers come with
the hybrid families.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.models import layers

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` (d, H*dh), ``wk``/``wv`` (d, HK*rep*dh), ``wo`` (H*dh, d),
    allocated uninitialised; :func:`init` draws them."""

    def __init__(self, cfg: ModelCfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        hk = cfg.n_kv_heads * _kv_rep(cfg)
        kw = {"dtype": dtype, "device": device}
        self.wq = layers.frozen(torch.empty((d, h * dh), **kw))
        self.wk = layers.frozen(torch.empty((d, hk * dh), **kw))
        self.wv = layers.frozen(torch.empty((d, hk * dh), **kw))
        self.wo = layers.frozen(torch.empty((h * dh, d), **kw))


def init(generator, cfg: ModelCfg, dtype=torch.bfloat16,
         device=None) -> Attention:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wk = layers.dense_init(generator, d, hk * dh, dtype, device)
    wv = layers.dense_init(generator, d, hk * dh, dtype, device)
    pre = cfg.parallel.kv_replicate
    if pre > 1:
        # weight-space KV replication: each KV head's columns duplicated,
        # as the reference stores them
        def tile(w):
            return w.reshape(d, hk, dh).repeat_interleave(pre, dim=1).reshape(
                d, hk * pre * dh)
        wk, wv = tile(wk), tile(wv)
    a = Attention(cfg, dtype, device)
    a.wq.copy_(layers.dense_init(generator, d, h * dh, dtype, device))
    a.wk.copy_(wk)
    a.wv.copy_(wv)
    a.wo.copy_(layers.dense_init(generator, h * dh, d, dtype, device))
    return a


def _kv_rep(cfg: ModelCfg) -> int:
    """Total KV replication: the reference's at a tensor-parallel width of
    1, where only the stored ``kv_replicate`` remains."""
    return max(1, cfg.parallel.kv_replicate)


def _project_qkv(params: Attention, x: torch.Tensor, cfg: ModelCfg,
                 positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,dh), k/v (B,S,HK*rep,dh), rope applied."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    hk_stored = cfg.n_kv_heads * _kv_rep(cfg)
    q = (x @ params.wq).reshape(b, s, h, dh)
    k = (x @ params.wk).reshape(b, s, hk_stored, dh)
    v = (x @ params.wv).reshape(b, s, hk_stored, dh)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Grouped-GQA scores: (B,S,H,dh) x (B,T,HK,dh) -> (B,HK,G,S,T) f32."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, s, hk, h // hk, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return scores * (dh ** -0.5)


def _apply_probs(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,HK,G,S,T) f32 x (B,T,HK,dh) -> (B,S,H,dh), in ``v.dtype``."""
    b, hk, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hk * g, -1)


def _softmax_lp(scores: torch.Tensor) -> torch.Tensor:
    """Low-precision softmax: big tensors in bf16, reductions in f32."""
    s16 = scores.to(torch.bfloat16)
    m = s16.amax(dim=-1, keepdim=True)
    e = torch.exp(s16 - m)                               # bf16, values <= 1
    denom = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
    return e / denom.to(torch.bfloat16)


def full_attention(params: Attention, x: torch.Tensor, cfg: ModelCfg,
                   positions: torch.Tensor) -> torch.Tensor:
    """Causal full self-attention over (B, S, D) — training / prefill."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.parallel.attn_impl == "flash":
        from repro_torch.kernels.flash_attention import ops as fl_ops
        out = fl_ops.flash_attention_bshd(q, k, v, causal=True)
        return out.reshape(b, s, -1) @ params.wo
    scores = _gqa_scores(q, k)                           # (B,HK,G,S,T)
    causal = (positions[:, None, None, :, None]
              >= positions[:, None, None, None, :])
    scores = torch.where(causal, scores, NEG_INF)
    if cfg.parallel.attn_bf16_scores:
        probs = _softmax_lp(scores)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = _apply_probs(probs, v).reshape(b, s, -1)
    return out @ params.wo


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# ---------------------------------------------------------------------------

def cache_shape(cfg: ModelCfg, batch: int, max_len: int) -> tuple[tuple,
                                                                   tuple]:
    """(k_cache, v_cache) shapes for one full-attention layer."""
    shp = (batch, max_len, cfg.n_kv_heads * _kv_rep(cfg), cfg.head_dim)
    return shp, shp


def decode_attention(params: Attention, x: torch.Tensor, cache_kv, pos,
                     cfg: ModelCfg, active=None):
    """One decode step.  x: (B, 1, D); cache_kv: (k, v) each (B, T, HK, dh);
    pos: scalar OR per-slot (B,) int positions (continuous batching).
    ``active``: optional (B,) bool — inactive slots neither write the cache
    nor advance.  Returns (out (B,1,D), cache).

    The cache is written in place (the reference returns a new one): each
    active slot's new K/V, cast to the cache's dtype, lands at its
    position; an inactive slot's row is written back unchanged, where the
    reference routes its scatter out of range and drops it.
    """
    b = x.shape[0]
    k_cache, v_cache = cache_kv
    t = k_cache.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64,
                          device=x.device).expand(b)
    q, k_new, v_new = _project_qkv(params, x, cfg, pos[:, None])

    bi = torch.arange(b, device=x.device)
    slot = pos % t
    k_row = k_new[:, 0].to(k_cache.dtype)
    v_row = v_new[:, 0].to(v_cache.dtype)
    if active is not None:
        keep = ~torch.as_tensor(active, dtype=torch.bool,
                                device=x.device)[:, None, None]
        k_row = torch.where(keep, k_cache[bi, slot], k_row)
        v_row = torch.where(keep, v_cache[bi, slot], v_row)
    k_cache[bi, slot] = k_row
    v_cache[bi, slot] = v_row

    scores = _gqa_scores(q, k_cache)                     # (B,HK,G,1,T)
    valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _apply_probs(probs, v_cache).reshape(b, 1, -1)
    return _matmul(out, params.wo), (k_cache, v_cache)


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype, as jnp's ``@`` promotes mixed
    operands (a bf16 cache read against float32 weights)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)
