"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

:func:`flash_attention` replaces the Pallas ``flash_attention``
(``src/repro/kernels/flash_attention/kernel.py``): causal (or full) GQA
attention with the reference kernel's online softmax, -1e30 mask fill,
probabilities cast to ``v.dtype`` before the product with V and float32
accumulation.  Query head ``bh`` reads KV head ``bh // group``; K and V
are never repeated.  Any Sq and Skv are taken (the kernel masks its ragged
tiles); the block-multiple contract of the reference lives in
:mod:`~repro_torch.kernels.flash_attention.ops`.

The dtype picks the kernel, by design and not as a fallback: bfloat16
inputs run the tensor-core kernel (``mma.sync`` bf16 products with float32
accumulation, FlashAttention-2's structure), float32 inputs the CUDA-core
kernel in full float32 (TF32 tensor cores would break the reference's 2e-5
tolerance).  Both count as ``flash_attention`` launches.

The wrapper takes CUDA tensors only and checks device, dtype, shape and
contiguity; it allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch returns a CUDA error.  It counts
its launches in :data:`launches`.  The library is built and loaded at the
first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LaunchCounts, check, raise_on, stream

#: Largest head dimension the kernel takes.
MAX_HEAD_DIM = 256

#: Wrapper calls that launched their kernel, by kernel name.
launches = LaunchCounts("flash_attention")
reset_launches = launches.reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not hasattr(lib, "_repro_bound"):
        lib.flash_attention_launch.argtypes = ([_VP] * 4 + [_I] * 6
                                               + [_F, _I, _VP])
        lib.flash_attention_launch.restype = _I
        lib._repro_bound = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    group: int, causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, dh); k/v: (BH//group, Skv, dh) -> (BH, Sq, dh).

    All float32 (CUDA-core kernel) or all bfloat16 (tensor-core kernel) on
    one CUDA device; 1 <= dh <= 256.
    """
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("q must be a CUDA tensor")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q must be (BH, Sq, dh) and k, v (BHK, Skv, dh)")
    (bh, sq, dh), (bhk, skv) = q.shape, k.shape[:2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if group < 1 or bh != bhk * group:
        raise ValueError(f"BH={bh} != BHK={bhk} * group={group}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside [1, {MAX_HEAD_DIM}]")
    if sq < 1 or skv < 1:
        raise ValueError(f"empty operand: Sq={sq}, Skv={skv}")
    dev = q.device
    check("q", q, q.dtype, (bh, sq, dh), dev)
    check("k", k, q.dtype, (bhk, skv, dh), dev)
    check("v", v, q.dtype, (bhk, skv, dh), dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            skv, dh, group, int(causal), dh ** -0.5, _DTYPES[q.dtype],
            stream(dev))
    raise_on(err, "flash_attention")
    launches.add("flash_attention")
    return out
