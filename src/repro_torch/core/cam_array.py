"""Functional + analog-behavioural SEE-MCAM array models (paper Sec. III-B/C).

Port of :mod:`repro.core.cam_array`.  Two array variants built on the
2FeFET MIBO cell (:mod:`repro_torch.core.mibo`):

* **NOR-type 2FeFET-1T** (Fig. 5): every cell's node D gates one NMOS hanging on
  a precharged matchline.  ML stays HIGH iff *all* cells match; any mismatching
  cell discharges it.  The analog discharge current is proportional to the
  number of mismatching cells, which is what lets a CAM double as a
  nearest-Hamming associative memory (Sec. IV-B).

* **NAND-type 2FeFET-2T precharge-free** (Fig. 6): cells chain through
  inverters, ``ML_i = ML_{i-1} * not(D_i)`` (Eq. 3).  The word matches iff the
  final ML is HIGH.  Energy is event-driven: a node only consumes charge when
  it *transitions* between consecutive searches — the functional simulator
  counts these transitions so the analytical model in
  :mod:`repro_torch.core.energy` can be cross-checked against simulation.

The arrays operate on integer symbols in [0, 2**bits) on one device (the
GPU unless ``device="cpu"``); all search paths are vectorised over query
batches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fefet, mibo
from repro_torch.device import resolve_device

#: Elements of one (Q, rows, cells) intermediate of :func:`analog_search_batch`
#: per query chunk (2^24 float32 = 64 MiB).
ANALOG_CHUNK_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class SEEMCAMConfig:
    """Array geometry + cell precision.

    Attributes:
      bits:     bits per cell (1..6 validated; the ladder generalises further).
      n_cells:  cells per word (row) — N in Eqs. (1)-(2).
      n_rows:   number of stored words searched in parallel.
      variant:  "nor" (2FeFET-1T) or "nand" (2FeFET-2T precharge-free).
    """

    bits: int = 3
    n_cells: int = 32
    n_rows: int = 64
    variant: str = "nor"

    def __post_init__(self):
        if self.variant not in ("nor", "nand"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if not 1 <= self.bits <= 6:
            raise ValueError(f"bits out of supported range: {self.bits}")

    @property
    def levels(self) -> int:
        return 1 << self.bits


@dataclasses.dataclass
class SearchResult:
    """Outcome of one parallel search over all rows."""

    match: torch.Tensor           # (rows,) bool — exact word match
    mismatch_count: torch.Tensor  # (rows,) int32 — #mismatching cells
    ml_discharge_current: torch.Tensor  # (rows,) float32 — analog ML current
    d_voltages: torch.Tensor      # (rows, cells) float32 — node-D voltages


class SEEMCAMArray:
    """A programmed SEE-MCAM array; functional search + analog diagnostics."""

    def __init__(self, config: SEEMCAMConfig, *,
                 params: fefet.FeFETParams = fefet.DEFAULT, device=None):
        self.config = config
        self.params = params
        self.device = resolve_device(device)
        self._codes: torch.Tensor | None = None      # (rows, cells) int32
        self._noise1: torch.Tensor | None = None     # (rows, cells) F1 noise
        self._noise2: torch.Tensor | None = None
        # NAND event-driven state: previous per-cell chain node levels.
        self._prev_ml_chain: torch.Tensor | None = None
        self.transition_count = 0                    # accumulated chain events

    # -- write path ---------------------------------------------------------

    def program(self, codes, *, generator: torch.Generator | None = None
                ) -> None:
        """Write integer symbols (rows, cells); optionally draw V_TH variation.

        With ``generator``, the F1 and F2 noise planes are drawn from it in
        that order (the reference draws them from a JAX key).  Follows the
        row-write scheme of Sec. III-B, modelled as a full-array reprogram.
        """
        codes = torch.as_tensor(codes, device=self.device).to(torch.int32)
        if codes.dim() != 2 or tuple(codes.shape) != (self.config.n_rows,
                                                      self.config.n_cells):
            raise ValueError(
                f"codes shape {tuple(codes.shape)} != "
                f"({self.config.n_rows}, {self.config.n_cells})")
        if (int(codes.max()) >= self.config.levels
                or int(codes.min()) < 0):
            raise ValueError("code symbol out of range for cell precision")
        self._codes = codes
        if generator is not None:
            shape = tuple(codes.shape)
            self._noise1 = fefet.sample_vth_variation(
                generator, shape, self.params, device=self.device)
            self._noise2 = fefet.sample_vth_variation(
                generator, shape, self.params, device=self.device)
        else:
            self._noise1 = self._noise2 = None
        self._prev_ml_chain = None
        self.transition_count = 0

    @property
    def codes(self) -> torch.Tensor:
        if self._codes is None:
            raise RuntimeError("array not programmed")
        return self._codes

    # -- search path --------------------------------------------------------

    def search(self, query) -> SearchResult:
        """One parallel associative search of ``query`` (cells,) over all rows."""
        query = torch.as_tensor(query, device=self.device).to(torch.int32)
        cfg = self.config
        if tuple(query.shape) != (cfg.n_cells,):
            raise ValueError(f"query shape {tuple(query.shape)} != "
                             f"({cfg.n_cells},)")

        codes = self.codes
        d_v = mibo.mibo_d_voltage(codes, query[None, :], cfg.bits,
                                  self._noise1, self._noise2, self.params)
        i_cell = mibo.mibo_current(codes, query[None, :], cfg.bits,
                                   self._noise1, self._noise2, self.params)
        d_high = i_cell > mibo.I_D_THRESHOLD           # (rows, cells) mismatch
        mismatch_count = d_high.sum(dim=-1, dtype=torch.int32)

        if cfg.variant == "nor":
            # Precharged ML discharges through every ON access NMOS: the
            # discharge current ~ sum of conducting-cell currents.
            match = mismatch_count == 0
            i_ml = torch.where(d_high, i_cell, 0.0).sum(dim=-1)
        else:
            # NAND chain: ml_i = ml_{i-1} & ~D_i  (Eq. 3) — prefix product.
            chain = torch.cumprod((~d_high).to(torch.int32), dim=-1)
            match = chain[:, -1].bool()
            i_ml = torch.where(
                match, torch.zeros((), device=self.device),
                torch.tensor(mibo.I_D_THRESHOLD, dtype=torch.float32,
                             device=self.device))      # no static path
            self._account_nand_transitions(chain)

        return SearchResult(match=match, mismatch_count=mismatch_count,
                            ml_discharge_current=i_ml, d_voltages=d_v)

    def _account_nand_transitions(self, chain: torch.Tensor) -> None:
        """Count chain-node level changes between consecutive searches.

        The precharge-free scheme (Sec. III-C) only spends energy when a chain
        node transitions; consecutive same-state searches are free.
        """
        if self._prev_ml_chain is not None:
            self.transition_count += int((chain != self._prev_ml_chain).sum())
        else:
            # First search after program: every HIGH node had to be charged.
            self.transition_count += int(chain.sum())
        self._prev_ml_chain = chain

    def search_batch(self, queries) -> tuple[torch.Tensor, torch.Tensor]:
        """Vectorised search: returns (match (Q, rows) bool, mismatch (Q, rows))."""
        queries = torch.as_tensor(queries, device=self.device).to(torch.int32)
        return _search_batch(self.codes, queries, self.config.bits,
                             self.config.variant == "nand")

    def best_match(self, queries) -> torch.Tensor:
        """Associative-memory readout: row index with the fewest mismatching
        cells per query (the analog ML-discharge-slope ranking of Sec. IV-B)."""
        queries = torch.atleast_2d(
            torch.as_tensor(queries, device=self.device).to(torch.int32))
        _, mm = self.search_batch(queries)
        return torch.argmin(mm, dim=-1).to(torch.int32)


def analog_search_batch(codes: torch.Tensor, queries: torch.Tensor, bits: int,
                        vth_noise1: torch.Tensor | None = None,
                        vth_noise2: torch.Tensor | None = None,
                        params: fefet.FeFETParams = fefet.DEFAULT,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched analog NOR-array search through the full device model.

    The (Q, rows, cells) current tensor is evaluated in query chunks of at
    most :data:`ANALOG_CHUNK_ELEMENTS` elements, so the memory it takes is
    bounded; each query's result depends on that query alone, so chunking
    leaves every result unchanged.

    Args:
      codes:   (rows, cells) stored int symbols.
      queries: (Q, cells) int query symbols, on the device of ``codes``.
      vth_noise1/2: optional (rows, cells) V_TH perturbations of F1/F2
        (device variation, see :func:`repro_torch.core.fefet.sample_vth_variation`).

    Returns:
      ``(mismatch, i_ml)``: (Q, rows) int32 mismatching-cell counts and
      (Q, rows) float32 matchline discharge currents (A) — the sum of the
      conducting cells' pull-up currents, each graded by the level distance
      of its mismatch (the analog L1 ranking of Sec. IV-B).
    """
    rows, cells = codes.shape
    step = max(1, ANALOG_CHUNK_ELEMENTS // max(1, rows * cells))
    mismatch, i_ml = [], []
    for s in range(0, max(1, queries.shape[0]), step):
        i_cell = mibo.mibo_current(codes[None], queries[s:s + step, None, :],
                                   bits, vth_noise1, vth_noise2, params)
        d_high = i_cell > mibo.I_D_THRESHOLD
        mismatch.append(d_high.sum(dim=-1, dtype=torch.int32))
        i_ml.append(torch.where(d_high, i_cell, 0.0).sum(dim=-1))
    return torch.cat(mismatch), torch.cat(i_ml)


def _search_batch(codes: torch.Tensor, queries: torch.Tensor, bits: int,
                  nand: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, cells) queries vs (rows, cells) codes -> ((Q, rows) match, mismatch)."""
    d_high = mibo.mibo_xor(codes[None], queries[:, None, :], bits)  # (Q,R,C)
    mismatch = d_high.sum(dim=-1, dtype=torch.int32)
    if nand:
        match = torch.cumprod((~d_high).to(torch.int32), dim=-1)[..., -1]
        match = match.bool()
    else:
        match = mismatch == 0
    return match, mismatch
