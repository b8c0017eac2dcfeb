"""Shared model layers: initializers, RMSNorm, rotary embeddings, SwiGLU.

Port of :mod:`repro.models.layers`.  Weights keep the reference's
(d_in, d_out) orientation and are applied as ``x @ W``; random draws take a
``torch.Generator``.  The ``*_specs`` sharding functions of the reference
belong to the sharding slice and are not here.
"""

from __future__ import annotations

import torch
from torch import nn


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _truncated_normal(generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], float32, drawn on ``device``."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                 generator=generator)


def dense_init(generator: torch.Generator | None, d_in: int, d_out: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """(d_in, d_out) weight: truncated normal on +-2 sigma, scaled by
    1/sqrt(d_in), drawn in float32 and cast to ``dtype``."""
    w = _truncated_normal(generator, (d_in, d_out), device)
    return w.mul_((1.0 / d_in) ** 0.5).to(dtype)


def embed_init(generator: torch.Generator | None, vocab: int, d: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """(vocab, d) embedding table: truncated normal on +-2 sigma."""
    return _truncated_normal(generator, (vocab, d), device).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm (fp32 statistics, cast back to activation dtype)
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """Holds the float32 ``scale`` of one RMSNorm (initialised to ones)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = frozen(torch.ones((d,), dtype=torch.float32,
                                        device=device))


def rmsnorm(params: RMSNorm, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params.scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S).

    Half-split rotation (not interleaved), computed in float32.
    """
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)      # (dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU) — the dense FFN used by all LM archs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``w_gate``, ``w_up`` (d_model, d_ff) and ``w_down`` (d_ff, d_model),
    allocated uninitialised; :func:`mlp_init` draws them."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        kw = {"dtype": dtype, "device": device}
        self.w_gate = frozen(torch.empty((d_model, d_ff), **kw))
        self.w_up = frozen(torch.empty((d_model, d_ff), **kw))
        self.w_down = frozen(torch.empty((d_ff, d_model), **kw))


def mlp_init(generator, d_model: int, d_ff: int, dtype=torch.bfloat16,
             device=None) -> MLP:
    m = MLP(d_model, d_ff, dtype, device)
    for w in (m.w_gate, m.w_up, m.w_down):
        w.copy_(dense_init(generator, w.shape[0], w.shape[1], dtype, device))
    return m


def mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    g = x @ params.w_gate
    # silu as the reference writes it: x * sigmoid(x), each op rounded
    h = g * torch.sigmoid(g) * (x @ params.w_up)
    return h @ params.w_down
