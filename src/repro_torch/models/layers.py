"""Shared model layers: initializers, RMSNorm, rotary embeddings, SwiGLU.

Port of :mod:`repro.models.layers`.  Weights keep the reference's
(d_in, d_out) orientation and are applied as ``x @ W``; random draws take a
``torch.Generator``.  :func:`mlp_specs` gives the MLP's weight specs as
tuples of axis names (:mod:`repro_torch.dist.specs`).
"""

from __future__ import annotations

import contextvars
import copy

import torch
from torch import nn

#: While set, :func:`scan` hands its loop to this callable, ``(step, carry,
#: xs, n) -> (carry, y)``: a cost counter that runs one step and counts its
#: work ``n`` times (:mod:`repro_torch.launch.dryrun`).  Unset, the loop
#: runs every step.
SCAN_COUNTER: contextvars.ContextVar = contextvars.ContextVar(
    "scan_counter", default=None)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient: serving builds no autograd
    graph.  Training turns ``requires_grad`` on for its own weights."""
    return nn.Parameter(t, requires_grad=False)


def frozen_empty(module: nn.Module, shapes: dict, device=None) -> None:
    """Give ``module`` a frozen, uninitialised parameter for each
    ``name: (shape, dtype)`` of ``shapes``, in that order."""
    for name, (shape, dtype) in shapes.items():
        setattr(module, name, frozen(torch.empty(shape, dtype=dtype,
                                                 device=device)))


class LayerStack:
    """One leaf of the reference's parameter tree made of per-layer
    tensors: what the reference holds as one (L, ...) array of a scanned
    layer stack.  Nothing is stacked on the device; ``shape`` and
    ``ndim`` are those of the stacked leaf."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts), *self.parts[0].shape)

    @property
    def ndim(self) -> int:
        return 1 + self.parts[0].ndim

    @property
    def device(self) -> torch.device:
        return self.parts[0].device


def module_like(module: nn.Module, tensors: dict) -> nn.Module:
    """A structural copy of ``module`` whose parameters are ``tensors``
    (by ``named_parameters()`` name), each keeping the ``requires_grad`` of
    the one it replaces.  Nothing of ``module``'s own storage is copied.
    """
    new = copy.copy(module)
    new._parameters = {
        name: None if p is None else nn.Parameter(tensors[name],
                                                  p.requires_grad)
        for name, p in module._parameters.items()}
    new._modules = {}
    for name, sub in module._modules.items():
        pre = name + "."
        new._modules[name] = None if sub is None else module_like(
            sub, {k[len(pre):]: v for k, v in tensors.items()
                  if k.startswith(pre)})
    return new


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


def mlp_specs(rules) -> dict:
    """The MLP's weight specs: gate and up column-parallel, down
    row-parallel."""
    return {"w_gate": rules.w2(), "w_up": rules.w2(),
            "w_down": rules.w2_row()}


def silu(x: torch.Tensor) -> torch.Tensor:
    """silu as the reference writes it: x * sigmoid(x), each op rounded."""
    return x * torch.sigmoid(x)


def mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    h = silu(x @ params.w_gate) * (x @ params.w_up)
    return h @ params.w_down


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype, as jnp's ``@`` promotes mixed
    operands (a bf16 activation or cache read against float32 weights)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def scan(step, carry, xs: tuple, n: int):
    """A loop over time, as the reference's ``lax.scan``: ``step(carry,
    xs_t) -> (carry, y_t)`` for t < ``n``, ``xs_t`` each tensor of ``xs``
    at index t of dim 1.  Returns (the last carry, the ``y_t`` stacked
    along dim 1).  Under :data:`SCAN_COUNTER` one step runs, its output
    standing for all ``n``."""
    counter = SCAN_COUNTER.get()
    if counter is not None and n > 1:
        return counter(step, carry, xs, n)
    ys = []
    for t in range(n):
        carry, y = step(carry, tuple(x[:, t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: torch.Tensor | None = None):
    """Depthwise causal convolution of width ``len(w)`` over dim 1.
    x: (B,S,R); w: (W,R); state: (B,W-1,R), the previous inputs (zeros
    when None).  Returns (out, new state), out summed tap by tap in
    ``x``'s dtype as the reference sums it."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, R)
    s = x.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, -(width - 1):]
