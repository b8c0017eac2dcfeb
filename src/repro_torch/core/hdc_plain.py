"""Plain float32 HDC classification: the semantics of
:func:`repro_torch.core.hdc.classify`, in plain torch operations.

The features go through the projection in full float32 (TF32 off for
matrix products, cuDNN's too), each symbol is the count of Gaussian
thresholds its product exceeds once scaled by the row norm, ``code =
#{t : (x @ P) > t * ||x||}`` with ``||x|| = sqrt(sum x^2 + 1e-12)``, and
the classes are ranked by the integer L1 distance of their codes,
ascending (distance, class id).  It imports no module of the port and no
kernel: the thresholds are copied (``repro_torch.core.quantize.
gaussian_thresholds_np``, float32).
"""

from __future__ import annotations

import torch

#: Equal-probability quantiles of N(0, 1) in float32, by bits per symbol.
THRESHOLDS = {
    1: (0.0,),
    2: (-0.6744897365570068, 0.0, 0.6744897365570068),
    3: (-1.1503493785858154, -0.6744897365570068, -0.3186393678188324, 0.0,
        0.3186393678188324, 0.6744897365570068, 1.1503493785858154),
}

#: Queries of one block of the distance computation.
QUERY_BLOCK = 256


def encode(x: torch.Tensor, projection: torch.Tensor,
           bits: int = 3) -> torch.Tensor:
    """(B, n) float32 features -> (B, D) int32 level codes."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        h = torch.matmul(x.float(), projection.float())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
    code = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    for t in THRESHOLDS[bits]:
        code += h > t * norm
    return code


def l1_distances(codes: torch.Tensor, class_codes: torch.Tensor
                 ) -> torch.Tensor:
    """(B, D) and (K, D) level codes -> (B, K) int64 L1 distances."""
    c = class_codes.long()
    out = []
    for s in range(0, codes.shape[0], QUERY_BLOCK):
        q = codes[s:s + QUERY_BLOCK].long()
        out.append((q[:, None, :] - c[None, :, :]).abs().sum(dim=-1))
    return torch.cat(out)


def classify(x: torch.Tensor, projection: torch.Tensor,
             class_codes: torch.Tensor, k: int = 1, bits: int = 3):
    """((B, k) int64 class ids, (B, k) int64 L1 distances) of the ``k``
    nearest classes of each row of ``x``, ascending (distance, class id)."""
    d = l1_distances(encode(x, projection, bits), class_codes)
    n = d.shape[1]
    key = d * n + torch.arange(n, device=d.device)
    key = torch.topk(key, min(k, n), dim=1, largest=False).values
    return key % n, key // n
