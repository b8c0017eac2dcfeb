"""Analytical search energy / latency / area models for SEE-MCAM arrays.

A copy of :mod:`repro.core.energy` (pure Python floats, no tensors), so
every number equals the reference's.

Reproduces the paper's array-level evaluation (Sec. IV-A): Figs. 7-8 scaling
curves and the Table II comparison.  The paper evaluates with Cadence
transients + DESTINY wiring parasitics on a 45 nm FeFET / 40 nm UMC PDK; this
module replaces SPICE with closed-form RC/CV**2 models whose named constants
are **calibrated so the "This work" rows of Table II are reproduced**:

    NOR  2FeFET-1T : 0.060 fJ/bit,  371.8 ps  @ 32 cells/word, 3 bits/cell
    NAND 2FeFET-2T : 0.039 fJ/bit,  2040  ps  @ 32 cells/word, 3 bits/cell

Matchline capacitance follows the paper's Eqs. (1)-(2):

    FeCAM     :  C_ML ~ C_dP + N (2 C_FeFET + C_par)      (Eq. 1)
    this work :  C_ML ~ C_dP + N (C_NMOS  + C_par)        (Eq. 2)

All energies in femtojoules, latencies in picoseconds, areas in um^2.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Calibrated circuit constants (40 nm CMOS / 45 nm FeFET, DESTINY parasitics)
# ---------------------------------------------------------------------------

V_PRE = 0.80        # ML precharge level (V)
V_SL = 0.80         # sourceline high level during search (V)
V_WL_SWING = 1.20   # wordline search-voltage swing (V), spans the VWL ladder

C_DP = 0.40         # drain cap of the ML precharge PMOS (fF)
C_NMOS = 0.100      # drain cap of the 2FeFET-1T access NMOS on ML (fF)
C_FEFET = 0.140     # FeFET drain cap (fF) — Eq. (1) term for FeCAM baseline
C_PAR = 0.060       # per-cell ML wiring parasitic (fF), DESTINY-extracted scale
C_D_NODE = 0.052    # MIBO output node D cap (fF) (NMOS gate + FeFET drains)
C_WL_GATE = 0.050   # per-FeFET gate cap seen by a WL driver (fF)
C_SL_CELL = 0.030   # per-cell SL loading (fF)
WL_TOGGLE = 0.15    # average WL level-change activity between searches

# NAND (precharge-free) chain constants
C_STAGE = 0.300     # per-stage chain node cap (inverter out + next supply) (fF)
C_INV_IN = 0.120    # inverter input cap on node D (fF)
NAND_ACT = 0.732    # calibrated average chain/D/SL activity factor

I_NMOS_EFF = 8.12e-6   # effective ML pulldown current of one access NMOS (A)
DV_SENSE = 0.40        # ML swing to the TIQ sense-amp threshold (V)
T_SA_NOR = 100.0       # TIQ sense-amp delay (ps), NOR array
T_SA_NAND = 120.0      # sense-amp delay (ps), NAND array
T_STAGE_NAND = 60.0    # per-cell chain propagation delay (ps)
T_WL = 0.0             # WL/SL setup absorbed in driver pipelining (ps)

# Layout-estimated device footprints (um^2) from the paper's 2x2 array layout
A_FEFET = 0.140
A_MOS = 0.080
A_CMOS_SRAMCELL_16T = 1.12 * 1.0   # 16T CMOS CAM bit area, Table II

# ---------------------------------------------------------------------------


def nor_ml_capacitance(n_cells: int) -> float:
    """C_ML of the 2FeFET-1T array, Eq. (2) (fF)."""
    return C_DP + n_cells * (C_NMOS + C_PAR)


def fecam_ml_capacitance(n_cells: int) -> float:
    """C_ML of the FeCAM baseline [17], Eq. (1) (fF) — for comparison plots."""
    return C_DP + n_cells * (2 * C_FEFET + C_PAR)


def _word_drive_energy(n_cells: int, p_mismatch_cell: float) -> float:
    """Per-word WL/SL/D-node switching energy common to both variants (fJ)."""
    e_wl = 2 * n_cells * C_WL_GATE * V_WL_SWING ** 2 * WL_TOGGLE
    e_sl = n_cells * C_SL_CELL * V_SL ** 2
    e_d = n_cells * p_mismatch_cell * C_D_NODE * V_SL ** 2
    return e_wl + e_sl + e_d


def nor_search_energy_word(n_cells: int, bits: int,
                           p_match_cell: float | None = None) -> float:
    """Average NOR-type search energy per word (fJ).

    ``p_match_cell``: probability a single cell matches; defaults to uniform
    random symbols (1/2**bits), the regime of the paper's array evaluation.
    """
    if p_match_cell is None:
        p_match_cell = 1.0 / (1 << bits)
    p_word_mismatch = 1.0 - p_match_cell ** n_cells  # ML discharges
    e_ml = nor_ml_capacitance(n_cells) * V_PRE ** 2 * p_word_mismatch
    return e_ml + _word_drive_energy(n_cells, 1.0 - p_match_cell)


def nand_expected_chain_events(n_cells: int, bits: int,
                               p_match_cell: float | None = None) -> float:
    """Expected HIGH chain nodes per word after one search (Sec. III-C).

    Chain node i is HIGH iff the first i cells all match — probability p**i
    for uniform random symbols — so the expectation is the geometric tail sum
    ``sum_{i=1..N} p^i``.  Starting from the discharged (just-programmed)
    state every HIGH node is one charging event, which is the per-search
    chain-energy term of :func:`nand_search_energy_word`; the functional
    simulator (``SEEMCAMArray.transition_count``) counts the same events.
    """
    if p_match_cell is None:
        p_match_cell = 1.0 / (1 << bits)
    p = p_match_cell
    if p >= 1:
        return float(n_cells)
    return p * (1.0 - p ** n_cells) / (1.0 - p)


def nand_expected_transitions_per_search(n_cells: int, bits: int,
                                         p_match_cell: float | None = None
                                         ) -> float:
    """Expected chain-node level CHANGES between consecutive random searches.

    Node i is HIGH with probability q_i = p**i independently across searches,
    so it transitions (either direction) with probability 2 q_i (1 - q_i):
    ``sum_i 2 p^i (1 - p^i)``.  Half of these are charging (0 -> 1) events,
    bounded above by :func:`nand_expected_chain_events` — the steady-state
    regime the event-driven energy model assumes.
    """
    if p_match_cell is None:
        p_match_cell = 1.0 / (1 << bits)
    p = p_match_cell
    if p >= 1:
        return 0.0
    up = nand_expected_chain_events(n_cells, bits, p)            # sum p^i
    up2 = nand_expected_chain_events(n_cells, bits, p * p)       # sum p^2i
    return 2.0 * (up - up2)


def nand_search_energy_word(n_cells: int, bits: int,
                            p_match_cell: float | None = None) -> float:
    """Average precharge-free NAND-type search energy per word (fJ).

    Chain node i only charges when all previous i-1 cells match and the node
    transitions (Sec. III-C) — probability ~ p**i for random inputs, so the
    expected number of charging events is the geometric tail sum.  The D-node
    and inverter-input switching dominates, scaled by the calibrated average
    activity factor ``NAND_ACT``.
    """
    if p_match_cell is None:
        p_match_cell = 1.0 / (1 << bits)
    exp_chain_events = nand_expected_chain_events(n_cells, bits, p_match_cell)
    e_chain = exp_chain_events * C_STAGE * V_PRE ** 2
    e_d = n_cells * NAND_ACT * (C_INV_IN + C_D_NODE) * V_SL ** 2
    e_wl = 2 * n_cells * C_WL_GATE * V_WL_SWING ** 2 * WL_TOGGLE
    e_sl = n_cells * C_SL_CELL * V_SL ** 2 * NAND_ACT
    return e_chain + e_d + e_wl + e_sl


def search_energy_per_bit(variant: str, n_cells: int, bits: int,
                          p_match_cell: float | None = None) -> float:
    """Search energy per stored bit (fJ) — the Table II metric."""
    if variant == "nor":
        e_word = nor_search_energy_word(n_cells, bits, p_match_cell)
    elif variant == "nand":
        e_word = nand_search_energy_word(n_cells, bits, p_match_cell)
    else:
        raise ValueError(variant)
    return e_word / (n_cells * bits)


def search_energy_array(variant: str, n_rows: int, n_cells: int, bits: int,
                        p_match_cell: float | None = None) -> float:
    """Total array search energy (fJ): rows are independent => linear in rows
    (the Fig. 7(a)/8(a) scaling)."""
    fn = nor_search_energy_word if variant == "nor" else nand_search_energy_word
    return n_rows * fn(n_cells, bits, p_match_cell)


def search_latency(variant: str, n_cells: int) -> float:
    """Worst-case (one mismatching cell) search latency (ps).

    NOR: a single access NMOS must discharge the whole ML — RC-limited, grows
    with C_ML(N).  NAND: the match state ripples through all N stages.
    """
    if variant == "nor":
        c_ml = nor_ml_capacitance(n_cells)  # fF
        t_disch = c_ml * 1e-15 * DV_SENSE / I_NMOS_EFF * 1e12  # ps
        return T_WL + t_disch + T_SA_NOR
    if variant == "nand":
        return T_WL + n_cells * T_STAGE_NAND + T_SA_NAND
    raise ValueError(variant)


def area_per_bit(variant: str, bits: int) -> float:
    """Cell area / bits (um^2) from the 2x2-array layout estimate."""
    n_mos = 1 if variant == "nor" else 2
    cell = 2 * A_FEFET + n_mos * A_MOS
    return cell / bits


# ---------------------------------------------------------------------------
# Table II literature rows (published numbers; used for ratio reporting only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CAMDesign:
    name: str
    device: str
    cell: str
    kind: str
    energy_fj_per_bit: float
    latency_ps: float | None
    area_um2_per_bit: float
    node: str


TABLE_II: tuple[CAMDesign, ...] = (
    CAMDesign("16T CMOS [8]", "CMOS", "16T", "BCAM", 0.59, 582.4, 1.12, "-/45"),
    CAMDesign("DAC'22 [32]", "FeFET", "2T-1FeFET", "BCAM", 0.116, 401.4, 0.36, "45/45"),
    CAMDesign("Nat Ele'19 [10]", "FeFET", "2FeFET", "TCAM", 0.40, 360.0, 0.15, "45/-"),
    CAMDesign("DATE'21 (P) [22]", "FeFET", "2FeFET-1T", "TCAM", 0.195, 252.8, 0.36, "45/45"),
    CAMDesign("DATE'21 (PF) [22]", "FeFET", "2FeFET-2T", "TCAM", 0.073, 1430.0, 0.44, "45/45"),
    CAMDesign("JSSC'13 [13]", "PCM", "2T-2R", "TCAM", 0.55, 350.6, 0.41, "90/90"),
    CAMDesign("NC'20 [15]", "ReRAM", "6T-2R", "ACAM", 0.52, 110.0, 0.51, "50/180"),
    CAMDesign("TED'20 [17]", "FeFET", "2FeFET", "MCAM/ACAM", 0.182, None, 0.05, "45/45"),
    CAMDesign("IEDM'20 [18]", "FeFET", "2FeFET-1T", "MCAM", 0.292, 422.0, 0.03, "28/-"),
)

#: Published reference point of this work (Table II), the calibration target.
THIS_WORK_NOR = CAMDesign("This work (P)", "FeFET", "2FeFET-1T", "MCAM",
                          0.060, 371.8, 0.12, "45/40")
THIS_WORK_NAND = CAMDesign("This work (PF)", "FeFET", "2FeFET-2T", "MCAM",
                           0.039, 2040.0, 0.146, "45/40")


def energy_ratios(n_cells: int = 32, bits: int = 3) -> dict[str, float]:
    """Energy-efficiency ratios of Table II vs our modelled NOR design."""
    ours = search_energy_per_bit("nor", n_cells, bits)
    return {d.name: d.energy_fj_per_bit / ours for d in TABLE_II}


def model_summary(n_cells: int = 32, bits: int = 3) -> dict[str, dict[str, float]]:
    """Modelled (energy/bit, latency, area/bit) for both variants."""
    out = {}
    for variant in ("nor", "nand"):
        out[variant] = {
            "energy_fj_per_bit": search_energy_per_bit(variant, n_cells, bits),
            "latency_ps": search_latency(variant, n_cells),
            "area_um2_per_bit": area_per_bit(variant, bits),
        }
    return out
