"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of :mod:`repro.models.rglru`.  Block = [linear input branch with GeLU
gate] x [temporal branch: causal depthwise conv(4) -> Real-Gated Linear
Recurrent Unit] -> down-projection.

RG-LRU per channel:

    r_t = sigmoid(x_t W_r + b_r)              (recurrence gate)
    i_t = sigmoid(x_t W_i + b_i)              (input gate)
    a_t = exp(-c * softplus(lam) * r_t)       (c = 8, learnable lam)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run the recurrence as a log-depth (Hillis-Steele)
scan over the sequence in torch ops (:func:`rglru_scan`); the reference
uses ``jax.lax.associative_scan``, whose combine tree differs, so the two
round differently (float32, a few ulps of the state).  Decode is a single
state update (:func:`rglru_step`): a (B, R) float32 state per layer.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.models import layers

C_RGLRU = 8.0
CONV_W = 4


class RGLRU(nn.Module):
    """``w_in_gate``, ``w_in_x`` (d, R), ``conv_w`` (4, R), ``w_r``,
    ``w_i`` (R, R), float32 ``b_r``, ``b_i`` and ``lam`` (R,), ``w_out``
    (R, d), with R = d; allocated uninitialised, :func:`init` draws
    them."""

    def __init__(self, cfg: ModelCfg, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = r = cfg.d_model        # lru_width = d_model in recurrentgemma-2b
        f32 = torch.float32
        layers.frozen_empty(self, {
            "w_in_gate": ((d, r), dtype), "w_in_x": ((d, r), dtype),
            "conv_w": ((CONV_W, r), dtype), "w_r": ((r, r), dtype),
            "b_r": ((r,), f32), "w_i": ((r, r), dtype), "b_i": ((r,), f32),
            "lam": ((r,), f32), "w_out": ((r, d), dtype)}, device)


def init(generator, cfg: ModelCfg, dtype=torch.bfloat16,
         device=None) -> RGLRU:
    p = RGLRU(cfg, dtype, device)
    d = r = cfg.d_model
    for w in (p.w_in_gate, p.w_in_x):
        w.copy_(layers.dense_init(generator, d, r, dtype, device))
    conv = torch.randn((CONV_W, r), generator=generator, device=device)
    p.conv_w.copy_(conv.mul_(0.1))
    for w, b in ((p.w_r, p.b_r), (p.w_i, p.b_i)):
        w.copy_(layers.dense_init(generator, r, r, dtype, device))
        b.zero_()
    # softplus(lam) ~ U[...] so a^(1/c) ~ U[0.9, 0.999] (Griffin init)
    u = torch.empty((r,), device=device).uniform_(0.9, 0.999,
                                                  generator=generator)
    p.lam.copy_(torch.log(torch.expm1(-torch.log(u) / C_RGLRU)))
    p.w_out.copy_(layers.dense_init(generator, r, d, dtype, device))
    return p


def specs(rules) -> dict:
    """Weight specs: the recurrence width R on tp."""
    return {"w_in_gate": rules.w2(), "w_in_x": rules.w2(),
            "conv_w": (None, rules.tp), "w_r": rules.w2(),
            "b_r": (rules.tp,), "w_i": rules.w2(), "b_i": (rules.tp,),
            "lam": (rules.tp,), "w_out": rules.w2_row()}


def _gates(params: RGLRU, x: torch.Tensor):
    r = torch.sigmoid((x @ params.w_r).float() + params.b_r)
    i = torch.sigmoid((x @ params.w_i).float() + params.b_i)
    log_a = -C_RGLRU * nn.functional.softplus(params.lam) * r   # (B,S,R) f32
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * x.float())
    return a, gated_x


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0, over dim 1 of (B, S, R):
    ceil(log2 S) Hillis-Steele rounds of the combine
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    for r in range(math.ceil(math.log2(s)) if s > 1 else 0):
        d = 1 << r
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    return b


def rglru_scan(params: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Parallel (log-depth scan) RG-LRU over (B, S, R)."""
    a, gx = _gates(params, x)
    return linear_scan(a, gx).to(x.dtype)


def rglru_step(params: RGLRU, x: torch.Tensor, h_prev: torch.Tensor):
    """Single decode step.  x: (B,1,R); h_prev: (B,R) float32 ->
    (out (B,1,R), new state (B,R) float32)."""
    a, gx = _gates(params, x)
    h = a[:, 0] * h_prev + gx[:, 0]
    return h.to(x.dtype)[:, None, :], h


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return nn.functional.gelu(x, approximate="tanh")


def block(params: RGLRU, x: torch.Tensor, cfg: ModelCfg) -> torch.Tensor:
    """Training/prefill recurrent block over (B, S, D)."""
    gate = _gelu(x @ params.w_in_gate)
    xr, _ = layers.causal_conv(x @ params.w_in_x, params.conv_w)
    h = rglru_scan(params, xr)
    return (h * gate) @ params.w_out


def state_shape(cfg: ModelCfg, batch: int) -> dict:
    r = cfg.d_model
    return {"h": (batch, r), "conv": (batch, CONV_W - 1, r)}


def block_decode(params: RGLRU, x: torch.Tensor, state: dict, cfg: ModelCfg):
    """Decode step.  x: (B,1,D); state: {"h": (B,R) f32, "conv": (B,3,R)}
    -> (out (B,1,D), new state)."""
    gate = _gelu(x @ params.w_in_gate)
    xr, conv_state = layers.causal_conv(x @ params.w_in_x, params.conv_w,
                                        state["conv"])
    h_out, h_new = rglru_step(params, xr, state["h"])
    out = (h_out * gate) @ params.w_out
    return out, {"h": h_new, "conv": conv_state.to(state["conv"].dtype)}
