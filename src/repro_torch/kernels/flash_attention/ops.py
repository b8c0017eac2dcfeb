"""Model-layer flash attention over (B, S, H, dh) tensors.

Port of :mod:`repro.kernels.flash_attention.ops`.  The device of ``q``
decides, and nothing else: CUDA tensors go to the hand-written kernel of
:mod:`~repro_torch.kernels.flash_attention.kernel` (which raises if it
cannot launch), CPU tensors to the plain version in
:mod:`~repro_torch.kernels.flash_attention.ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,dh); k/v: (B,T,HK,dh) -> (B,S,H,dh) (GQA: H % HK == 0).

    The reference tiles S and T in blocks of ``min(128, S)`` and
    ``min(128, T)`` and takes only lengths those blocks divide; so does
    this function, raising :class:`ValueError` where the reference asserts.
    """
    b, s, h, dh = q.shape
    _, t, hk, _ = k.shape
    if h % hk:
        raise ValueError(f"{h} query heads do not group over {hk} KV heads")
    group = h // hk
    blk_q, blk_k = min(128, s), min(128, t)
    if s % blk_q or t % blk_k:
        raise ValueError(f"S={s} and T={t} must be multiples of their "
                         f"blocks ({blk_q}, {blk_k})")
    # (B,S,H,dh) -> (B*H, S, dh) with heads grouped under their KV head
    qf = q.transpose(1, 2).reshape(b * h, s, dh).contiguous()
    kf = k.transpose(1, 2).reshape(b * hk, t, dh).contiguous()
    vf = v.transpose(1, 2).reshape(b * hk, t, dh).contiguous()
    run = _k.flash_attention if q.device.type == "cuda" else _ref.attention
    out = run(qf, kf, vf, group=group, causal=causal)
    return out.reshape(b, h, s, dh).transpose(1, 2)
