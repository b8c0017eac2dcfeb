"""The query words and the table fill of the service's lookups.

Copied from ``chip_smoke.py``: ``_perturb`` (a word with ``n_sym`` distinct
symbols moved by 1..levels-1, mod levels), here drawn for many words at
once on the device from a ``torch.Generator``, and the chunked fill of
``phase_service`` / ``_fill_indexed`` (65,536-row appends, each row's
payload its row id, an index built once inside the last append).
"""

from __future__ import annotations

import numpy as np
import torch

#: Rows of one perturbation block, to bound the (rows, width) temporaries.
_BLOCK = 1 << 16


def perturb(words: torch.Tensor, n_sym: int, levels: int,
            gen: torch.Generator) -> torch.Tensor:
    """Each row of ``words`` with ``n_sym`` distinct symbols changed."""
    out = words.clone()
    for s in range(0, words.shape[0], _BLOCK):
        w = out[s:s + _BLOCK]
        pos = torch.rand(w.shape, generator=gen, device=w.device).argsort(
            dim=1)[:, :n_sym]
        step = torch.randint(1, levels, (w.shape[0], n_sym), generator=gen,
                             device=w.device, dtype=w.dtype)
        w.scatter_(1, pos, (w.gather(1, pos) + step) % levels)
    return out


def fill(append, stored: np.ndarray, chunk: int) -> None:
    """Append ``stored`` in ``chunk``-row pieces, payload = row id."""
    for s in range(0, stored.shape[0], chunk):
        piece = stored[s:s + chunk].astype(np.int32)
        append(piece, list(range(s, s + piece.shape[0])))
