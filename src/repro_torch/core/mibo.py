"""2FeFET Multi-bit-Input Binary-Output (MIBO) XOR structure (paper Sec. III-A).

Port of :mod:`repro.core.mibo`.  Two FeFETs F1/F2 in parallel form a
push-pull pull-up from the sourceline SL to the output node D:

* storing symbol v in [0, M), M = 2**bits:  F1 <- VTH[v],  F2 <- VTH[M-1-v]
* searching symbol q:  gate(F1) <- VWL[q],  gate(F2) <- VWL[M-1-q],
  where VWL[k] sits in the gap below VTH[k]:  VTH[k-1] < VWL[k] < VTH[k].

Consequences (the MIBO XOR truth table, Table I):
  F1 conducts  <=>  v < q          F2 conducts  <=>  v > q
  => both OFF  <=>  v == q  (node D stays low: MATCH)
  => exactly ONE conducts on any mismatch (node D pulled high: MISMATCH).

Everything vectorises over leading axes in float32.  Symbols may be
tensors (their device is used) or host arrays (the GPU, or ``device=``
where a function takes it).
"""

from __future__ import annotations

import torch

from repro_torch.core import fefet
from repro_torch.core.fefet import DEFAULT, FeFETParams
from repro_torch.device import device_of

#: Sourceline high level (V) during search (supply of the push-pull structure).
V_SL = 0.80
#: Current threshold (A) separating "node D charged" from "node D floating low".
#: Geometric mean of I_ON and 2*I_OFF — maximal margin on both sides.
I_D_THRESHOLD = (fefet.I_ON * 2 * fefet.I_ON / fefet.ON_OFF_RATIO) ** 0.5


def _symbols(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).long()


def wl_levels(bits: int, params: FeFETParams = DEFAULT,
              device=None) -> torch.Tensor:
    """Search wordline voltage ladder VWL[k], k in [0, 2**bits).

    VWL[k] is the midpoint of (VTH[k-1], VTH[k]); VWL[0] sits half a rung below
    VTH[0].  This realises `F conducts <=> VTH < VWL` exactly between rungs.
    """
    vth = fefet.vth_levels(bits, params, device=device)
    step = (params.vth_max - params.vth_min) / max((1 << bits) - 1, 1)
    below = torch.cat([vth[:1] - step, vth[:-1]])
    return 0.5 * (below + vth)


def stored_vths(values, bits: int, params: FeFETParams = DEFAULT,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(V_TH of F1, V_TH of F2) encoding integer symbols ``values``."""
    dev = device_of(values, device=device)
    v = _symbols(values, dev)
    ladder = fefet.vth_levels(bits, params, device=dev)
    return ladder[v], ladder[(1 << bits) - 1 - v]


def search_gate_voltages(queries, bits: int, params: FeFETParams = DEFAULT,
                         device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(gate V of F1, gate V of F2) for integer query symbols ``queries``."""
    dev = device_of(queries, device=device)
    q = _symbols(queries, dev)
    ladder = wl_levels(bits, params, device=dev)
    return ladder[q], ladder[(1 << bits) - 1 - q]


def mibo_current(values, queries, bits: int, vth_noise1=None, vth_noise2=None,
                 params: FeFETParams = DEFAULT) -> torch.Tensor:
    """Total pull-up current (A) into node D for (stored, query) symbol pairs.

    ``vth_noise1/2`` optionally perturb F1/F2 threshold voltages (device
    variation, sigma = 54 mV) for Monte-Carlo robustness analysis (Fig. 9).
    """
    dev = device_of(values, queries)
    vth1, vth2 = stored_vths(values, bits, params, device=dev)
    if vth_noise1 is not None:
        vth1 = vth1 + torch.as_tensor(vth_noise1, device=dev)
    if vth_noise2 is not None:
        vth2 = vth2 + torch.as_tensor(vth_noise2, device=dev)
    g1, g2 = search_gate_voltages(queries, bits, params, device=dev)
    return (fefet.drain_current(g1, vth1, params)
            + fefet.drain_current(g2, vth2, params))


def mibo_d_voltage(values, queries, bits: int, vth_noise1=None,
                   vth_noise2=None, params: FeFETParams = DEFAULT
                   ) -> torch.Tensor:
    """Behavioural node-D voltage (V): smooth map of log-current around threshold.

    V_D ~ V_SL on a mismatch (a FeFET conducts), ~0 on a match.
    """
    i_d = mibo_current(values, queries, bits, vth_noise1, vth_noise2, params)
    thr = torch.tensor(I_D_THRESHOLD, dtype=torch.float32, device=i_d.device)
    x = torch.log(i_d) - torch.log(thr)
    return V_SL * torch.sigmoid(2.0 * x)


def mibo_xor(values, queries, bits: int) -> torch.Tensor:
    """Boolean MIBO XOR output: True = MISMATCH (D high), False = MATCH (D low)."""
    return mibo_current(values, queries, bits) > I_D_THRESHOLD


def overdrive_response_fit(bits: int,
                           params: FeFETParams = DEFAULT) -> tuple[float, float]:
    """Affine fit ``i_cell(g) ~= a + b * g`` of the per-cell mismatch current.

    A word's matchline discharge is the sum over mismatching cells, hence
    ``i_ml ~= a * mismatches + b * L1``; inverting this fit is what lets the
    analog backend report digital-equivalent L1 distances (``"analog_cal"``).
    Least squares over every realisable gap ``g = 1 .. 2**bits - 1``, through
    the full device model, in float32 as the reference computes it; for
    ``bits=1`` the fit is the exact proportional map ``(0, i(1))``.  Returns
    ``(a, b)`` in amperes (per mismatch / per level).  A host computation of
    a few values: it runs on the CPU.
    """
    m = 1 << bits
    gaps = torch.arange(1, m)
    cur = mibo_current(torch.zeros_like(gaps), gaps, bits, params=params)
    if m == 2:
        return 0.0, float(cur[0])
    g = gaps.to(torch.float32)
    gm, cm = g.mean(), cur.mean()
    b = ((g - gm) * (cur - cm)).sum() / ((g - gm) ** 2).sum()
    a = cm - b * gm
    return float(a), float(b)


def lsb_mismatch_current(bits: int, params: FeFETParams = DEFAULT,
                         device=None) -> torch.Tensor:
    """Pull-up current (A) of a single cell mismatching by exactly ONE level.

    The natural current unit of the analog associative ranking, derived
    through the device model so parameter overrides propagate: an exact
    match lands at ``~C * i_off / i_lsb << 0.5`` LSB mismatches and the
    smallest physical mismatch at ``~1.0``.
    """
    dev = device_of(device=device)
    return mibo_current(torch.tensor(0, device=dev),
                        torch.tensor(1, device=dev), bits, params=params)
