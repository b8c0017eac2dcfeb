"""Behavioural FeFET device model with multi-level-cell (MLC) V_TH states.

Port of :mod:`repro.core.fefet`.  Models the HfO2 FeFET of the paper (45 nm
Preisach-calibrated device, Fig. 1):

* ``vth_levels(bits)``      — the 2**bits programmable threshold-voltage ladder
                              (Fig. 1(c): >3-bit V_TH states).
* ``write_pulse_to_vth``    — monotone write-pulse-amplitude -> V_TH mapping
                              (Fig. 1(a): +/- gate pulses move polarization).
* ``drain_current``         — smooth logistic I_D(V_G; V_TH) transfer curve
                              (Fig. 1(b)) with a high I_ON/I_OFF ratio.
* ``sample_vth_variation``  — Gaussian device-to-device V_TH variation with the
                              experimentally measured sigma = 54 mV [37].

Everything is float32 (the reference runs with 64-bit types off) and
vectorises over leading axes.  Functions of tensors run on their device,
and host arrays go to the GPU; functions that build a tensor from nothing
take ``device=``, which defaults to the GPU
(:func:`repro_torch.device.device_of`).  The draw takes a
``torch.Generator`` where the reference takes a JAX key: the two give
different numbers, so tests hand both packages the same noise planes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import device_of

# ---------------------------------------------------------------------------
# Device constants (behavioural; calibrated against the paper's 45 nm device)
# ---------------------------------------------------------------------------

#: Saturated ON current of one FeFET (A). ~10 uA matches Fig. 1(b) scale.
I_ON = 10e-6
#: I_ON / I_OFF ratio; HfO2 FeFETs exhibit >1e6 (Sec. II-A).
ON_OFF_RATIO = 1e6
#: Sub-threshold slope factor (V) of the logistic transfer curve.
SS_V = 0.040
#: Above-threshold drive-current slope (1/V): I ~ I_ON * (1 + slope * (VG-VTH))
#: for VG > VTH.  This linear overdrive term is what makes the analog ML
#: discharge current of a mismatching word scale with the *level distance*,
#: the property the paper's HDC associative-memory ranking exploits.
OVERDRIVE_SLOPE = 2.0
#: Experimentally measured V_TH standard deviation (V) for low/high states [37].
SIGMA_VTH = 0.054
#: V_TH ladder range (V) for the MLC states (Fig. 1(c): ~3 V window).
VTH_MIN = 0.20
VTH_MAX = 3.20
#: Write-pulse amplitude range (V) that sweeps V_TH across the full ladder.
VPULSE_MIN = 2.0
VPULSE_MAX = 4.0


@dataclasses.dataclass(frozen=True)
class FeFETParams:
    """Bundle of behavioural FeFET constants (override for sensitivity studies)."""

    i_on: float = I_ON
    on_off_ratio: float = ON_OFF_RATIO
    ss_v: float = SS_V
    overdrive_slope: float = OVERDRIVE_SLOPE
    sigma_vth: float = SIGMA_VTH
    vth_min: float = VTH_MIN
    vth_max: float = VTH_MAX

    @property
    def i_off(self) -> float:
        return self.i_on / self.on_off_ratio


DEFAULT = FeFETParams()


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def vth_levels(bits: int, params: FeFETParams = DEFAULT,
               device=None) -> torch.Tensor:
    """The 2**bits-entry programmable V_TH ladder (ascending, volts).

    Evenly spaced levels across the polarization window, as in Fig. 1(c).
    """
    if bits < 1:
        raise ValueError(f"bits must be >= 1, got {bits}")
    return torch.linspace(params.vth_min, params.vth_max, 1 << bits,
                          dtype=torch.float32, device=device_of(device=device))


def write_pulse_to_vth(v_pulse, params: FeFETParams = DEFAULT
                       ) -> torch.Tensor:
    """Map a positive write-pulse amplitude (V) to the programmed V_TH (V).

    Monotone *decreasing*: a larger positive gate pulse switches more
    polarization toward the channel -> lower V_TH (Fig. 1(a)), clipped at
    the ladder ends.
    """
    v = _f32(v_pulse, device_of(v_pulse))
    frac = ((v - VPULSE_MIN) / (VPULSE_MAX - VPULSE_MIN)).clamp(0.0, 1.0)
    return params.vth_max - frac * (params.vth_max - params.vth_min)


def vth_to_write_pulse(vth, params: FeFETParams = DEFAULT) -> torch.Tensor:
    """Inverse of :func:`write_pulse_to_vth` (used by the array write scheme)."""
    v = _f32(vth, device_of(vth))
    frac = (params.vth_max - v) / (params.vth_max - params.vth_min)
    return VPULSE_MIN + frac.clamp(0.0, 1.0) * (VPULSE_MAX - VPULSE_MIN)


def drain_current(v_g, vth, params: FeFETParams = DEFAULT) -> torch.Tensor:
    """Behavioural I_D(V_G; V_TH) transfer curve (A), Fig. 1(b)/(c).

    Logistic switch between I_OFF and I_ON centred at V_TH, in log-current
    space, times a linear drive-current growth with the gate overdrive.
    """
    dev = device_of(v_g, vth)
    v_g, vth = _f32(v_g, dev), _f32(vth, dev)
    x = (v_g - vth) / params.ss_v
    log_on = torch.log(_f32(params.i_on, dev))
    log_off = torch.log(_f32(params.i_off, dev))
    s = torch.sigmoid(x)
    i_switch = torch.exp(log_off + (log_on - log_off) * s)
    overdrive = torch.clamp(v_g - vth, min=0.0)
    return i_switch * (1.0 + params.overdrive_slope * overdrive)


def sample_vth_variation(generator: torch.Generator | None,
                         shape: tuple[int, ...],
                         params: FeFETParams = DEFAULT,
                         device=None) -> torch.Tensor:
    """Gaussian V_TH perturbations (V) with the measured sigma = 54 mV [37].

    Drawn from ``generator`` (the default generator of the device when
    None) on ``device``, which defaults to the generator's device.
    """
    if device is None and generator is not None:
        device = generator.device
    dev = device_of(device=device)
    return params.sigma_vth * torch.randn(shape, generator=generator,
                                          dtype=torch.float32, device=dev)


def program_levels(values, bits: int) -> torch.Tensor:
    """V_TH programmed for integer symbol ``values`` in [0, 2**bits)."""
    dev = device_of(values)
    idx = torch.as_tensor(values, device=dev).long()
    return vth_levels(bits, device=dev)[idx]
