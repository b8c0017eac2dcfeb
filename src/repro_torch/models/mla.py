"""Multi-head Latent Attention (DeepSeek-V2): train/prefill and absorbed
decode.

Port of :mod:`repro.models.mla` on one device.  Geometry
(deepseek-v2-lite): kv_lora_rank 512, rope_head_dim 64, nope_head_dim 128,
v_head_dim 128, 16 query heads.

Train/prefill (:func:`full_attention`): the compressed KV latent c_kv
(B,S,512) is up-projected to per-head K_nope/V and attention runs in the
usual head space, scores in float32, scale ``(nope + rope) ** -0.5``.

Decode (:func:`decode_attention`): the *absorbed* form — W_uk is folded
into the query and W_uv into the output, so the cache stays in latent
space:

    score_t = q_nope^T W_uk c_t + q_rope^T k_rope_t
    out     = (sum_t p_t c_t)^T W_uv

Cache per layer: ``c_kv`` (B,T,512) and ``k_rope`` (B,T,64).  The
reference has no flash branch for MLA, and neither has the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.models import layers

NEG_INF = -1e30


class MLA(nn.Module):
    """``wq`` (d, H*(nope+rope)), ``w_dkv`` (d, rank+rope), ``w_uk`` (rank,
    H*nope), ``w_uv`` (rank, H*v), ``wo`` (H*v, d); allocated
    uninitialised, :func:`init` draws them."""

    def __init__(self, cfg: ModelCfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        shapes = {
            "wq": (d, h * (m.nope_head_dim + m.rope_head_dim)),
            "w_dkv": (d, m.kv_lora_rank + m.rope_head_dim),
            "w_uk": (m.kv_lora_rank, h * m.nope_head_dim),
            "w_uv": (m.kv_lora_rank, h * m.v_head_dim),
            "wo": (h * m.v_head_dim, d),
        }
        layers.frozen_empty(self, {name: (shp, dtype)
                                   for name, shp in shapes.items()}, device)


def init(generator, cfg: ModelCfg, dtype=torch.bfloat16, device=None) -> MLA:
    p = MLA(cfg, dtype, device)
    for w in (p.wq, p.w_dkv, p.w_uk, p.w_uv, p.wo):
        w.copy_(layers.dense_init(generator, w.shape[0], w.shape[1], dtype,
                                  device))
    return p


def specs(rules) -> dict:
    """Weight specs; the latent down-projection's small output (rank +
    rope) stays unsharded."""
    return {"wq": rules.w2(), "w_dkv": (rules.fsdp, None),
            "w_uk": rules.w2(), "w_uv": rules.w2(), "wo": rules.w2_row()}


def _project_q(params: MLA, x, cfg: ModelCfg, positions):
    m = cfg.mla
    b, s, _ = x.shape
    q = (x @ params.wq).reshape(b, s, cfg.n_heads,
                                m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(params: MLA, x, cfg: ModelCfg, positions):
    m = cfg.mla
    kv = x @ params.w_dkv                                   # (B,S,rank+rope)
    c_kv, k_rope = kv.split([m.kv_lora_rank, m.rope_head_dim], dim=-1)
    # rope through a dummy head axis, as the reference applies it
    k_rope = layers.apply_rope(k_rope[:, :, None, :], positions,
                               cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` in the promoted dtype, as jnp promotes mixed operands
    (a bf16 cache read against float32 weights)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def full_attention(params: MLA, x: torch.Tensor, cfg: ModelCfg,
                   positions: torch.Tensor) -> torch.Tensor:
    """Training / prefill MLA with materialised per-head K/V."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _project_q(params, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(params, x, cfg, positions)
    k_nope = (c_kv @ params.w_uk).reshape(b, s, h, m.nope_head_dim)
    v = (c_kv @ params.w_uv).reshape(b, s, h, m.v_head_dim)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float())) * scale
    causal = positions[:, None, :, None] >= positions[:, None, None, :]
    probs = torch.softmax(torch.where(causal, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
    return out.reshape(b, s, h * m.v_head_dim) @ params.wo


# ---------------------------------------------------------------------------
# Absorbed decode
# ---------------------------------------------------------------------------

def cache_shape(cfg: ModelCfg, batch: int, max_len: int) -> tuple[tuple,
                                                                   tuple]:
    """(c_kv, k_rope) shapes for one layer."""
    m = cfg.mla
    return (batch, max_len, m.kv_lora_rank), (batch, max_len, m.rope_head_dim)


def decode_attention(params: MLA, x: torch.Tensor, cache, pos,
                     cfg: ModelCfg, active=None):
    """Absorbed-matmul decode step.  ``cache`` = (c_kv, k_rope), written in
    place; ``pos``: scalar or per-slot (B,) positions.  Returns (out
    (B,1,D), cache).

    An inactive slot's cache row is written back unchanged, where the
    reference routes its scatter out of range and drops it.
    """
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)
    positions = pos[:, None]
    q_nope, q_rope = _project_q(params, x, cfg, positions)   # (B,1,H,*)
    c_new, kr_new = _project_kv_latent(params, x, cfg, positions)

    c_cache, kr_cache = cache
    bi = torch.arange(b, device=x.device)
    c_row = c_new[:, 0].to(c_cache.dtype)
    kr_row = kr_new[:, 0].to(kr_cache.dtype)
    if active is not None:
        keep = ~torch.as_tensor(active, dtype=torch.bool,
                                device=x.device)[:, None]
        c_row = torch.where(keep, c_cache[bi, pos], c_row)
        kr_row = torch.where(keep, kr_cache[bi, pos], kr_row)
    c_cache[bi, pos] = c_row
    kr_cache[bi, pos] = kr_row

    # absorb W_uk into the query: q_lat (B,1,H,rank)
    w_uk = params.w_uk.reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_cache.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             kr_cache.float())) * scale
    t = c_cache.shape[1]
    valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
    probs = torch.softmax(torch.where(valid[:, None, None, :], scores,
                                      NEG_INF), dim=-1)
    out_lat = torch.einsum("bhst,btr->bshr", probs.to(c_cache.dtype), c_cache)
    w_uv = params.w_uv.reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = _einsum("bshr,rhd->bshd", out_lat, w_uv)
    out = out.reshape(b, 1, h * m.v_head_dim) @ params.wo
    return out, (c_cache, kr_cache)
