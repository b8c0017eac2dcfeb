"""Functional models of the CAM baselines the paper compares against.

Port of :mod:`repro.core.baselines`.

* **2FeFET TCAM** [10] (Fig. 3(c)): binary storage with a "don't care"
  wildcard state (both FeFETs high-V_TH -> the cell never pulls the ML down).
* **FeCAM MCAM** [17] (Fig. 3(e)): 2FeFET multi-bit cell whose two device
  drains hang directly on the matchline — the same MIBO match semantics as
  SEE-MCAM, but with the Eq. (1) matchline capacitance
  C_ML ~ C_dP + N(2 C_FeFET + C_par), i.e. the higher precharge energy the
  2FeFET-1T design removes (Eq. (2)).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import energy, mibo
from repro_torch.device import resolve_device

#: TCAM wildcard symbol: matches any query value.
WILDCARD = -1


@dataclasses.dataclass(frozen=True)
class TCAMConfig:
    n_cells: int
    n_rows: int


class FeFETTCAMArray:
    """2FeFET ternary CAM [10]: binary values + don't-care wildcards."""

    def __init__(self, config: TCAMConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._codes: torch.Tensor | None = None

    def program(self, codes) -> None:
        """codes: (rows, cells) in {0, 1, WILDCARD}."""
        codes = torch.as_tensor(codes, device=self.device).to(torch.int32)
        if tuple(codes.shape) != (self.config.n_rows, self.config.n_cells):
            raise ValueError(tuple(codes.shape))
        self._codes = codes

    def search_batch(self, queries) -> tuple[torch.Tensor, torch.Tensor]:
        """(Q, cells) binary queries -> (match (Q, rows), mismatch counts).

        A wildcard cell stores high-V_TH in both FeFETs: neither gate voltage
        can turn a device on, so the cell never discharges the ML.
        """
        queries = torch.as_tensor(queries, device=self.device).to(torch.int32)
        codes = self._codes
        wild = codes[None] == WILDCARD
        # non-wild cells behave as 1-bit MIBO XOR
        mm = mibo.mibo_xor(codes.clamp(min=0)[None], queries[:, None, :], 1)
        counts = (mm & ~wild).sum(dim=-1, dtype=torch.int32)
        return counts == 0, counts


def fecam_search_energy_word(n_cells: int, bits: int,
                             p_match_cell: float | None = None) -> float:
    """FeCAM [17] per-word search energy (fJ): Eq. (1) matchline cap.

    Same drive/D-node terms as the SEE-MCAM NOR model; only C_ML differs —
    isolating the architectural contribution of the access transistor.
    """
    if p_match_cell is None:
        p_match_cell = 1.0 / (1 << bits)
    p_word_mismatch = 1.0 - p_match_cell ** n_cells
    e_ml = energy.fecam_ml_capacitance(n_cells) * energy.V_PRE ** 2 \
        * p_word_mismatch
    return e_ml + energy._word_drive_energy(n_cells, 1.0 - p_match_cell)


def fecam_energy_ratio(n_cells: int = 32, bits: int = 3) -> float:
    """SEE-MCAM NOR energy advantage over FeCAM from the C_ML terms alone."""
    return (fecam_search_energy_word(n_cells, bits)
            / energy.nor_search_energy_word(n_cells, bits))
