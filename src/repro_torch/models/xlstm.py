"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, sequential), both with
exponential gating.

Port of :mod:`repro.models.xlstm`.  mLSTM recurrence per head (state C:
(dk, dv) matrix, normaliser n: (dk,)):

    f_t = sigmoid(f~_t)   i_t = exp(i~_t)        (stabilised in log space)
    C_t = f_t C_{t-1} + i_t k_t v_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t^T q_t) / max(|n_t^T q_t|, 1)

Training and prefill use the chunkwise-parallel form: sequences are split
into chunks of W = 64; within a chunk the contribution is a masked
attention-like product with log-decay weights, and a loop over the chunks
carries (C, n, m) — O(S * W) work in block products.  The masks are -inf
and the stabiliser algebra is the reference's, so a masked weight is
``exp(-inf) = 0`` and no NaN arises.

sLSTM keeps a per-head scalar memory and is inherently sequential: a loop
over time (the reference's ``lax.scan``).  Decode for both is a single
state update.

Block layout follows xLSTM-125m: pre-norm, up-projection x2, causal conv(4)
feeding q/k, recurrence, learnable skip + gated down-projection.  There is
no separate MLP.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.models import layers

CHUNK = 64
CONV_W = 4


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``w_up``, ``w_gate`` (d, 2d), ``conv_w`` (4, 2d), ``wq``, ``wk``,
    ``wv`` (2d, H*dh), float32 ``w_if`` (2d, 2H) and ``b_if`` (2H,),
    ``w_down`` (2d, d), ``skip`` (2d,); allocated uninitialised,
    :func:`mlstm_init` draws them."""

    def __init__(self, cfg: ModelCfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        up = 2 * d
        f32 = torch.float32
        layers.frozen_empty(self, {
            "w_up": ((d, up), dtype), "w_gate": ((d, up), dtype),
            "conv_w": ((CONV_W, up), dtype), "wq": ((up, h * dh), dtype),
            "wk": ((up, h * dh), dtype), "wv": ((up, h * dh), dtype),
            "w_if": ((up, 2 * h), f32), "b_if": ((2 * h,), f32),
            "w_down": ((up, d), dtype), "skip": ((up,), dtype)}, device)


def mlstm_init(generator, cfg: ModelCfg, dtype=torch.bfloat16,
               device=None) -> MLSTM:
    p = MLSTM(cfg, dtype, device)
    h = cfg.n_heads
    for w in (p.w_up, p.w_gate):
        w.copy_(layers.dense_init(generator, *w.shape, dtype, device))
    p.conv_w.copy_(torch.randn(p.conv_w.shape, generator=generator,
                               device=device).mul_(0.1))
    for w in (p.wq, p.wk, p.wv):
        w.copy_(layers.dense_init(generator, *w.shape, dtype, device))
    p.w_if.copy_(layers.dense_init(generator, *p.w_if.shape, torch.float32,
                                   device))
    p.b_if.copy_(torch.cat([torch.zeros(h), 3.0 * torch.ones(h)]))
    p.w_down.copy_(layers.dense_init(generator, *p.w_down.shape, dtype,
                                     device))
    p.skip.copy_(torch.randn(p.skip.shape, generator=generator,
                             device=device).mul_(0.1))
    return p


def mlstm_specs(rules) -> dict:
    """The mLSTM block's weight specs."""
    return {"w_up": rules.w2(), "w_gate": rules.w2(),
            "conv_w": (None, rules.tp), "wq": rules.w2(), "wk": rules.w2(),
            "wv": rules.w2(), "w_if": (rules.fsdp, None), "b_if": (None,),
            "w_down": rules.w2_row(), "skip": (rules.tp,)}


def _mlstm_qkv(params: MLSTM, x: torch.Tensor, cfg: ModelCfg,
               conv_state=None):
    """x (B,S,D) -> up (B,S,U), q/k/v (B,S,H,dh), log input gate and log
    forget gate (B,S,H) float32, the new conv state."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    up = x @ params.w_up
    conv, new_conv = layers.causal_conv(up, params.conv_w, conv_state)
    act = layers.silu(conv)
    q = (act @ params.wq).reshape(b, s, h, dh)
    k = (act @ params.wk).reshape(b, s, h, dh) * (dh ** -0.5)
    v = (up @ params.wv).reshape(b, s, h, dh)
    gif = layers.matmul(act, params.w_if).float() + params.b_if
    gif = gif.reshape(b, s, 2, h)
    log_i, logit_f = gif[:, :, 0], gif[:, :, 1]
    log_f = nn.functional.logsigmoid(logit_f)              # (B,S,H)
    return up, q, k, v, log_i, log_f, new_conv


def _mlstm_chunkwise(q, k, v, log_i, log_f):
    """Chunkwise-parallel mLSTM.  q/k/v: (B,S,H,dh); gates (B,S,H) float32.

    Returns h: (B,S,H,dh) float32.  Stabilisation: per-chunk running max m.
    ``S`` must be a multiple of ``min(CHUNK, S)``.
    """
    b, s, h, dh = q.shape
    w = min(CHUNK, s)
    if s % w:
        raise ValueError(f"mLSTM over S={s} needs a multiple of {w}")
    nc = s // w
    qc = q.reshape(b, nc, w, h, dh).float()
    kc = k.reshape(b, nc, w, h, dh).float()
    vc = v.reshape(b, nc, w, h, dh).float()
    li = log_i.reshape(b, nc, w, h)
    lf_cum = torch.cumsum(log_f.reshape(b, nc, w, h), dim=2)  # inclusive
    lf_tot = lf_cum[:, :, -1]                                 # (B,NC,H)

    # ---- intra-chunk (parallel, attention-like) ---------------------------
    # weight(i<-j) = exp(lf_cum[i] - lf_cum[j] + li[j]), j <= i
    dmat = (lf_cum[:, :, :, None, :] - lf_cum[:, :, None, :, :]
            + li[:, :, None, :, :])                           # (B,NC,Wq,Wk,H)
    causal = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal[None, None, :, :, None], dmat, -torch.inf)
    m_intra = dmat.amax(dim=3)                                # (B,NC,Wq,H)

    carry = (q.new_zeros((b, h, dh, dh), dtype=torch.float32),
             q.new_zeros((b, h, dh), dtype=torch.float32),
             torch.full((b, h), -1e30, dtype=torch.float32, device=q.device))
    _, hs = layers.scan(_mlstm_chunk, carry, (qc, kc, vc, li, lf_cum, lf_tot,
                                              dmat, m_intra), nc)
    return hs.reshape(b, s, h, dh)


def _mlstm_chunk(carry, xs):
    """One chunk of :func:`_mlstm_chunkwise`: the carried (c, n, m) state
    and the chunk's q, k, v, log input gates, cumulative and total log
    forget gates, intra-chunk log weights and their maxima -> (the state at
    the chunk's end, the chunk's h (B,W,H,dh) float32)."""
    c_prev, n_prev, m_prev = carry
    qi, ki, vi, lii, lfc, lft, dm, mi = xs
    # stabiliser: incoming state decayed to position i vs intra-chunk max
    m_inter = lfc + m_prev[:, None, :]                        # (B,W,H)
    m_tot = torch.maximum(mi, m_inter)
    w_intra = torch.exp(dm - m_tot[:, :, None, :])            # (B,Wq,Wk,H)
    w_inter = torch.exp(m_inter - m_tot)                      # (B,W,H)

    scores = torch.einsum("bihd,bjhd->bijh", qi, ki) * w_intra
    h_num = (torch.einsum("bijh,bjhd->bihd", scores, vi)
             + torch.einsum("bihd,bhde->bihe", qi, c_prev)
             * w_inter[..., None])
    # denominator: q . (sum_j w_intra[i,j] k_j + w_inter[i] n_prev)
    n_comb = (torch.einsum("bijh,bjhd->bihd", w_intra, ki)
              + n_prev[:, None, :, :] * w_inter[..., None])
    den = torch.maximum(torch.abs(torch.sum(qi * n_comb, dim=-1)),
                        torch.exp(-m_tot))                    # (B,W,H)

    # ---- state update to end of chunk ------------------------------------
    # decay from in-chunk position j to the chunk end
    log_w = lft[:, None, :] - lfc + lii                       # (B,W,H)
    m_next = torch.maximum(lft + m_prev, log_w.amax(dim=1))
    decay = torch.exp(lft + m_prev - m_next)                  # (B,H)
    w_state = torch.exp(log_w - m_next[:, None, :])           # (B,W,H)
    c_next = (c_prev * decay[..., None, None]
              + torch.einsum("bjh,bjhd,bjhe->bhde", w_state, ki, vi))
    n_next = (n_prev * decay[..., None]
              + torch.einsum("bjh,bjhd->bhd", w_state, ki))
    return (c_next, n_next, m_next), h_num / den[..., None]


def _mix(params: MLSTM, x, hh, up):
    """The gated down-projection.  hh (h*dh wide) is coupled back through
    the up-projection width as the reference couples it: repeated twice
    when that fills the width, else zero-padded."""
    gate = layers.silu(x @ params.w_gate)
    width = gate.shape[-1]
    if hh.shape[-1] * 2 == width:
        mixed = torch.cat([hh, hh], dim=-1)
    else:
        mixed = nn.functional.pad(hh, (0, width - hh.shape[-1]))
    return (gate * (mixed + params.skip * up)) @ params.w_down


def mlstm_block(params: MLSTM, x: torch.Tensor, cfg: ModelCfg):
    b, s, _ = x.shape
    up, q, k, v, log_i, log_f, _ = _mlstm_qkv(params, x, cfg)
    hh = _mlstm_chunkwise(q, k, v, log_i, log_f).reshape(b, s, -1).to(x.dtype)
    return _mix(params, x, hh, up)


def mlstm_state_shape(cfg: ModelCfg, batch: int) -> dict:
    h, dh = cfg.n_heads, cfg.head_dim
    return {"c": (batch, h, dh, dh), "n": (batch, h, dh), "m": (batch, h),
            "conv": (batch, CONV_W - 1, 2 * cfg.d_model)}


def mlstm_block_decode(params: MLSTM, x: torch.Tensor, state: dict,
                       cfg: ModelCfg):
    """Single-token recurrent update (the exact mLSTM recurrence) ->
    (out (B,1,D), new state)."""
    b = x.shape[0]
    up, q, k, v, log_i, log_f, new_conv = _mlstm_qkv(
        params, x, cfg, conv_state=state["conv"])
    q1, k1, v1 = (t[:, 0].float() for t in (q, k, v))             # (B,H,dh)
    li, lf = log_i[:, 0], log_f[:, 0]                               # (B,H)
    m_prev, c_prev, n_prev = state["m"], state["c"], state["n"]
    m_new = torch.maximum(lf + m_prev, li)
    f_eff = torch.exp(lf + m_prev - m_new)
    i_eff = torch.exp(li - m_new)
    c_new = (c_prev * f_eff[..., None, None]
             + i_eff[..., None, None] * k1[..., :, None] * v1[..., None, :])
    n_new = n_prev * f_eff[..., None] + i_eff[..., None] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, c_new)
    den = torch.maximum(torch.abs(torch.sum(q1 * n_new, dim=-1)),
                        torch.exp(-m_new))
    hh = (num / den[..., None]).reshape(b, 1, -1).to(x.dtype)
    out = _mix(params, x, hh, up)
    return out, {"c": c_new, "n": n_new, "m": m_new,
                 "conv": new_conv.to(state["conv"].dtype)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``w_zifo`` (d, 4d) the fused z/i/f/o pre-activations, float32
    ``b_zifo`` (4d,), ``w_down`` (d, d); allocated uninitialised,
    :func:`slstm_init` draws them."""

    def __init__(self, cfg: ModelCfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = cfg.d_model
        layers.frozen_empty(self, {"w_zifo": ((d, 4 * d), dtype),
                                   "b_zifo": ((4 * d,), torch.float32),
                                   "w_down": ((d, d), dtype)}, device)


def slstm_init(generator, cfg: ModelCfg, dtype=torch.bfloat16,
               device=None) -> SLSTM:
    p = SLSTM(cfg, dtype, device)
    p.w_zifo.copy_(layers.dense_init(generator, *p.w_zifo.shape, dtype,
                                     device))
    p.b_zifo.zero_()
    p.w_down.copy_(layers.dense_init(generator, *p.w_down.shape, dtype,
                                     device))
    return p


def slstm_specs(rules) -> dict:
    """The sLSTM block's weight specs."""
    return {"w_zifo": rules.w2(), "b_zifo": (None,),
            "w_down": rules.w2_row()}


def _slstm_gates(params: SLSTM, x: torch.Tensor):
    zifo = (x @ params.w_zifo).float() + params.b_zifo
    z, i, f, o = zifo.chunk(4, dim=-1)
    return (torch.tanh(z), i, nn.functional.logsigmoid(f),
            torch.sigmoid(o))


def _slstm_step(carry, xs):
    c_prev, n_prev, m_prev = carry
    z, log_i, log_f, o = xs
    m_new = torch.maximum(log_f + m_prev, log_i)
    i_eff = torch.exp(log_i - m_new)
    f_eff = torch.exp(log_f + m_prev - m_new)
    c_new = f_eff * c_prev + i_eff * z
    n_new = f_eff * n_prev + i_eff
    h = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new), h


def slstm_block(params: SLSTM, x: torch.Tensor, cfg: ModelCfg):
    """sLSTM over (B, S, D): one :func:`_slstm_step` per position."""
    b, s, d = x.shape
    z, i, log_f, o = _slstm_gates(params, x)
    zeros = x.new_zeros((b, d), dtype=torch.float32)
    carry = (zeros, zeros, torch.full_like(zeros, -1e30))
    _, hs = layers.scan(_slstm_step, carry, (z, i, log_f, o), s)
    return hs.to(x.dtype) @ params.w_down


def slstm_state_shape(cfg: ModelCfg, batch: int) -> dict:
    d = cfg.d_model
    return {"c": (batch, d), "n": (batch, d), "m": (batch, d)}


def slstm_block_decode(params: SLSTM, x: torch.Tensor, state: dict,
                       cfg: ModelCfg):
    z, i, log_f, o = _slstm_gates(params, x)
    carry = (state["c"], state["n"], state["m"])
    carry, h = _slstm_step(carry, (z[:, 0], i[:, 0], log_f[:, 0], o[:, 0]))
    out = h[:, None, :].to(x.dtype) @ params.w_down
    return out, {"c": carry[0], "n": carry[1], "m": carry[2]}
