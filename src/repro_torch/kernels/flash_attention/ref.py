"""Plain PyTorch version of the flash-attention kernel.

Port of :mod:`repro.kernels.flash_attention.ref`: the KV heads repeated per
group, float32 scores times ``dh ** -0.5``, the causal mask filled with the
finite -1e30 (top-left aligned), softmax, and the probabilities cast to
``v.dtype`` before the product with V.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              group: int, causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, dh); k/v: (BH//group, Skv, dh) -> (BH, Sq, dh)."""
    bh, sq, dh = q.shape
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * (dh ** -0.5)
    if causal:
        skv = k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p.to(v.dtype), v).to(q.dtype)
