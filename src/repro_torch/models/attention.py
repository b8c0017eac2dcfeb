"""Attention: GQA/MQA/MHA, full causal self-attention and cached decode.

Port of :mod:`repro.models.attention` on one device.  The reference's
sharding constraints are the identity there, so they fall away, and its
KV replication up to the tensor-parallel width reduces to the stored
``kv_replicate`` (:func:`_kv_rep`).  Attention math accumulates in float32;
masks fill with the finite -1e30.

Local (sliding-window) layers: :func:`local_attention` is chunked over the
window W, so its cost is O(S * W), and a local layer's decode cache is a
ring buffer of ``min(max_len, W)`` slots.
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


def specs(rules) -> dict:
    """Weight specs: q, k, v column-parallel, the output row-parallel."""
    return {"wq": rules.w2(), "wk": rules.w2(), "wv": rules.w2(),
            "wo": rules.w2_row()}


def _cache_spec(rules) -> tuple:
    """(B, T, HK, dh) K or V cache: B on dp; heads on tp, or the sequence
    on tp under cp."""
    if rules.layout == "tp":
        return (rules.dp, None, rules.tp, None)
    return (rules.dp, rules.tp, None, None)


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
    """Causal full self-attention over (B, S, D) — training / prefill.

    ``attn_impl="flash"`` is forward-only: with grad enabled and an input
    that requires grad it raises :class:`NotImplementedError`.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.parallel.attn_impl == "flash":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "attn_impl='flash' is forward-only: the reference's Pallas "
                "flash kernel has no backward, so training runs "
                "attn_impl='einsum', as the reference does")
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


def local_attention(params: Attention, x: torch.Tensor, cfg: ModelCfg,
                    positions: torch.Tensor) -> torch.Tensor:
    """Sliding-window attention (window W), chunked so cost is O(S * W).

    Queries in chunk c attend to keys in chunks {c-1, c} with an exact
    banded mask; an (S, S) score matrix is never materialised.  ``S`` must
    be a multiple of W when it exceeds W.
    """
    b, s, _ = x.shape
    w = cfg.local_window
    q, k, v = _project_qkv(params, x, cfg, positions)
    if s <= w:
        return _local_fallback(params, q, k, v, positions, cfg)
    if s % w:
        raise ValueError(f"local attention over S={s} needs a multiple of "
                         f"the window {w}")
    c = s // w
    h, dh = cfg.n_heads, cfg.head_dim
    hk = k.shape[2]
    qc = q.reshape(b, c, w, hk, h // hk, dh)
    kc = k.reshape(b, c, w, hk, dh)
    vc = v.reshape(b, c, w, hk, dh)
    # keys for chunk c = [chunk c-1 ; chunk c]  (length 2W window coverage)
    k2 = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]],
                              dim=1), kc], dim=2)           # (B,C,2W,HK,dh)
    v2 = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]],
                              dim=1), vc], dim=2)
    pos_q = positions.reshape(b, c, w)
    pos_k = torch.cat([torch.cat([torch.full_like(pos_q[:, :1], -1),
                                  pos_q[:, :-1]], dim=1), pos_q], dim=2)
    scores = torch.einsum("bcskgd,bctkd->bckgst", qc.float(),
                          k2.float()) * (dh ** -0.5)
    pq = pos_q[:, :, None, None, :, None]
    pk = pos_k[:, :, None, None, None, :]
    valid = (pq >= pk) & (pq - pk < w) & (pk >= 0)
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    out = torch.einsum("bckgst,bctkd->bcskgd", probs.to(v2.dtype), v2)
    return out.reshape(b, s, h * dh) @ params.wo


def _local_fallback(params: Attention, q, k, v, positions, cfg: ModelCfg):
    """Short-sequence path (S <= W): a banded mask over the full (small)
    score matrix."""
    b, s = q.shape[:2]
    scores = _gqa_scores(q, k)
    dpos = (positions[:, None, None, :, None]
            - positions[:, None, None, None, :])
    valid = (dpos >= 0) & (dpos < cfg.local_window)
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    return _apply_probs(probs, v).reshape(b, s, -1) @ params.wo


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# ---------------------------------------------------------------------------

def cache_shape(cfg: ModelCfg, batch: int, max_len: int,
                local: bool = False) -> tuple[tuple, tuple]:
    """(k_cache, v_cache) shapes for one layer; a local layer keeps
    ``min(max_len, local_window)`` ring slots."""
    t = min(max_len, cfg.local_window) if local else max_len
    shp = (batch, t, cfg.n_kv_heads * _kv_rep(cfg), cfg.head_dim)
    return shp, shp


def decode_attention(params: Attention, x: torch.Tensor, cache_kv, pos,
                     cfg: ModelCfg, local: bool = False, active=None):
    """One decode step.  x: (B, 1, D); cache_kv: (k, v) each (B, T, HK, dh);
    pos: scalar OR per-slot (B,) int positions (continuous batching).
    ``active``: optional (B,) bool — inactive slots neither write the cache
    nor advance.  Returns (out (B,1,D), cache).

    The cache is written in place (the reference returns a new one): each
    active slot's new K/V, cast to the cache's dtype, lands at its
    position; an inactive slot's row is written back unchanged, where the
    reference routes its scatter out of range and drops it.  A local layer
    treats its cache as a ring buffer: position p lives in slot p % T.
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
    kv_idx = torch.arange(t, device=x.device)
    if local:
        rp = _ring_positions(kv_idx, pos, t)   # (B,T) stored global pos
        # rp < 0 marks ring slots never written yet (prefix not full)
        valid = (rp >= 0) & (pos[:, None] - rp < cfg.local_window)
    else:
        valid = kv_idx[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _apply_probs(probs, v_cache).reshape(b, 1, -1)
    return layers.matmul(out, params.wo), (k_cache, v_cache)


def _ring_positions(kv_idx, pos, t):
    """(B,T) global position stored in ring slot i at current positions."""
    cur_slot = (pos % t)[:, None]
    offset = kv_idx[None, :] - cur_slot
    return pos[:, None] + torch.where(offset > 0, offset - t, offset)
