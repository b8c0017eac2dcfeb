"""Port parity: the FeFET device model against the JAX package, on the CPU.

``fefet``, ``mibo``, ``cam_array``, the analog backends, ``energy``,
``baselines`` and the Monte-Carlo kernel's plain version, each given the
same numpy inputs (and the reference's random draws, passed in) as its
reference.  Tolerances and why:

* ``fefet``/``mibo`` ladders, voltages, the transfer curve on a grid and
  the overdrive fit: rtol 1e-6 (float32 ops in the same order);
* ``mibo`` cell currents under V_TH noise: rtol 5e-6.  The current is
  ``exp(log_off + 13.8 * sigmoid(x))``, so a one-ulp difference in the
  sigmoid moves it by up to 13.8 ulps of the exponent, and the reference's
  CPU ``exp`` is not correctly rounded (it differs from the rounded value
  on about 9 % of float32 inputs); 2.3e-6 was the largest difference seen;
* match flags, mismatch counts and NAND transition counts: bitwise;
* currents through the device model: rtol 1e-5 (summed over cells);
* ``mibo_mc``: rtol 1e-5, atol 1e-12, the reference's kernel tolerance
  (``tests/test_kernels.py``), against its Pallas kernel in interpret mode;
* analog distances: rtol 1e-5; top-k rows equal except where two
  candidates' distances lie within that tolerance of each other;
* ``energy`` and ``baselines``: equal (both are the same float arithmetic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import am as jam
from repro.core import baselines as jbase
from repro.core import cam_array as jcam
from repro.core import energy as jenergy
from repro.core import fefet as jfefet
from repro.core import mibo as jmibo
from repro.kernels.mibo_mc import kernel as j_mc_kernel
from repro_torch.core import am, baselines, cam_array, energy, fefet, mibo
from repro_torch.kernels.mibo_mc import ops as mc_ops
from repro_torch.kernels.mibo_mc import ref as mc_ref

torch.set_num_threads(2)

CPU = "cpu"
RTOL = 1e-6
CURRENT_RTOL = 5e-6


def _allclose(got, want, rtol=RTOL, atol=0.0):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# fefet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_fefet_ladders_and_write_pulses(bits):
    lv = fefet.vth_levels(bits, device=CPU)
    assert lv.dtype == torch.float32
    _allclose(lv, jfefet.vth_levels(bits))
    _allclose(fefet.vth_to_write_pulse(lv),
              jfefet.vth_to_write_pulse(jfefet.vth_levels(bits)))
    pulses = np.linspace(1.5, 4.5, 13, dtype=np.float32)
    _allclose(fefet.write_pulse_to_vth(torch.from_numpy(pulses)),
              jfefet.write_pulse_to_vth(pulses))
    values = np.arange(1 << bits) % (1 << bits)
    _allclose(fefet.program_levels(torch.from_numpy(values), bits),
              jfefet.program_levels(jnp.asarray(values), bits))
    with pytest.raises(ValueError, match="bits"):
        fefet.vth_levels(0, device=CPU)


def test_fefet_drain_current_grid():
    g, v = np.meshgrid(np.linspace(-0.5, 3.5, 41, dtype=np.float32),
                       np.linspace(0.0, 3.3, 37, dtype=np.float32))
    _allclose(fefet.drain_current(torch.from_numpy(g), torch.from_numpy(v)),
              jfefet.drain_current(g, v))
    p = fefet.FeFETParams(ss_v=0.06, overdrive_slope=1.0)
    jp = jfefet.FeFETParams(ss_v=0.06, overdrive_slope=1.0)
    _allclose(fefet.drain_current(torch.from_numpy(g), torch.from_numpy(v),
                                  p),
              jfefet.drain_current(g, v, jp))


def test_fefet_variation_draws_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    a = fefet.sample_vth_variation(gen, (4000,))
    gen.manual_seed(0)
    assert torch.equal(a, fefet.sample_vth_variation(gen, (4000,)))
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert abs(float(a.std()) - fefet.SIGMA_VTH) < 0.005
    assert abs(float(a.mean())) < 0.005


# ---------------------------------------------------------------------------
# mibo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3])
def test_mibo_ladders_and_currents(bits):
    m = 1 << bits
    assert mibo.I_D_THRESHOLD == jmibo.I_D_THRESHOLD
    _allclose(mibo.wl_levels(bits, device=CPU), jmibo.wl_levels(bits))
    v, q = np.meshgrid(np.arange(m), np.arange(m))
    for got, want in zip(mibo.stored_vths(torch.from_numpy(v), bits),
                         jmibo.stored_vths(jnp.asarray(v), bits)):
        _allclose(got, want)
    for got, want in zip(mibo.search_gate_voltages(torch.from_numpy(q), bits),
                         jmibo.search_gate_voltages(jnp.asarray(q), bits)):
        _allclose(got, want)
    rng = np.random.default_rng(bits)
    n1 = (0.054 * rng.normal(size=v.shape)).astype(np.float32)
    n2 = (0.054 * rng.normal(size=v.shape)).astype(np.float32)
    args = (torch.from_numpy(v), torch.from_numpy(q), bits)
    jargs = (jnp.asarray(v), jnp.asarray(q), bits)
    _allclose(mibo.mibo_current(*args), jmibo.mibo_current(*jargs))
    _allclose(mibo.mibo_current(*args, torch.from_numpy(n1),
                                torch.from_numpy(n2)),
              jmibo.mibo_current(*jargs, n1, n2), rtol=CURRENT_RTOL)
    _allclose(mibo.mibo_d_voltage(*args, torch.from_numpy(n1),
                                  torch.from_numpy(n2)),
              jmibo.mibo_d_voltage(*jargs, n1, n2), rtol=CURRENT_RTOL,
              atol=1e-7)
    xor = mibo.mibo_xor(*args)
    np.testing.assert_array_equal(xor.numpy(), np.asarray(
        jmibo.mibo_xor(*jargs)))
    np.testing.assert_array_equal(xor.numpy(), v != q)    # Table I
    _allclose(mibo.lsb_mismatch_current(bits, device=CPU),
              jmibo.lsb_mismatch_current(bits))
    np.testing.assert_allclose(mibo.overdrive_response_fit(bits),
                               jmibo.overdrive_response_fit(bits), rtol=RTOL)


# ---------------------------------------------------------------------------
# mibo_mc: the plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,c", [(256, 32), (512, 8), (1024, 64), (100, 17)])
def test_mibo_mc_matches_reference_kernel(s, c):
    rng = np.random.default_rng(s + c)
    stored = rng.integers(0, 8, c)
    query = rng.integers(0, 8, c)
    n1 = (0.054 * rng.normal(size=(s, c))).astype(np.float32)
    n2 = (0.054 * rng.normal(size=(s, c))).astype(np.float32)
    vth1, vth2 = jmibo.stored_vths(jnp.asarray(stored), 3)
    g1, g2 = jmibo.search_gate_voltages(jnp.asarray(query), 3)
    want = j_mc_kernel.mibo_mc(vth1[None] + n1, vth2[None] + n2,
                               g1[None].astype(jnp.float32),
                               g2[None].astype(jnp.float32),
                               block_s=256 if s % 256 == 0 else s,
                               interpret=True)
    tv1, tv2 = mibo.stored_vths(torch.from_numpy(stored), 3)
    tg1, tg2 = mibo.search_gate_voltages(torch.from_numpy(query), 3)
    got = mc_ref.ml_currents(tv1[None] + torch.from_numpy(n1),
                             tv2[None] + torch.from_numpy(n2),
                             tg1[None], tg2[None])
    assert got.shape == (s, 1) and got.dtype == torch.float32
    _allclose(got, want, rtol=1e-5, atol=1e-12)
    # the ops entry point with the noise planes passed in: the same thing
    via_ops = mc_ops.ml_currents_with_noise(
        torch.from_numpy(stored), torch.from_numpy(query),
        torch.from_numpy(n1), torch.from_numpy(n2))
    _allclose(via_ops, np.asarray(want)[:, 0], rtol=1e-5, atol=1e-12)


def test_monte_carlo_margin_separation():
    """Fig. 9 on the port: the worst-case (adjacent-level, one cell)
    mismatch current stays clear of the match leakage."""
    rng = np.random.default_rng(3)
    stored = torch.from_numpy(rng.integers(0, 8, 32))
    worst = stored.clone()
    worst[0] = (worst[0] + 1) % 8
    gen = torch.Generator().manual_seed(3)
    i_match = mc_ops.monte_carlo_ml_currents(stored, stored, n_samples=512,
                                             generator=gen)
    i_mm = mc_ops.monte_carlo_ml_currents(stored, worst, n_samples=512,
                                          generator=gen)
    assert i_match.shape == (512,) and i_match.dtype == torch.float32
    assert float(torch.quantile(i_mm, 0.01)) > 3 * float(
        torch.quantile(i_match, 0.99))
    assert float(i_mm.min()) > float(i_match.max())
    # the generator decides the draw
    again = mc_ops.monte_carlo_ml_currents(
        stored, stored, n_samples=512,
        generator=torch.Generator().manual_seed(3))
    assert torch.equal(again, i_match)


# ---------------------------------------------------------------------------
# cam_array
# ---------------------------------------------------------------------------

def _codes_queries(bits, rows, cells, n_q, seed):
    key = jax.random.PRNGKey(seed)
    codes = np.array(jax.random.randint(key, (rows, cells), 0, 1 << bits))
    qs = np.array(jax.random.randint(jax.random.fold_in(key, 1),
                                       (n_q, cells), 0, 1 << bits))
    qs[0] = codes[min(2, rows - 1)]                  # one exact hit
    return codes, qs


@pytest.mark.parametrize("variant", ["nor", "nand"])
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_array_search_matches_reference(bits, variant):
    codes, qs = _codes_queries(bits, 24, 20, 6, bits)
    jarr = jcam.SEEMCAMArray(jcam.SEEMCAMConfig(
        bits=bits, n_cells=20, n_rows=24, variant=variant))
    arr = cam_array.SEEMCAMArray(cam_array.SEEMCAMConfig(
        bits=bits, n_cells=20, n_rows=24, variant=variant), device=CPU)
    jarr.program(codes)
    arr.program(codes)
    for q in qs:
        w, g = jarr.search(q), arr.search(q)
        np.testing.assert_array_equal(g.match.numpy(), np.asarray(w.match))
        assert g.mismatch_count.dtype == torch.int32
        np.testing.assert_array_equal(g.mismatch_count.numpy(),
                                      np.asarray(w.mismatch_count))
        _allclose(g.ml_discharge_current, w.ml_discharge_current, rtol=1e-5)
        _allclose(g.d_voltages, w.d_voltages, rtol=1e-5, atol=1e-7)
        assert arr.transition_count == jarr.transition_count
    m, mm = arr.search_batch(qs)
    jm_, jmm = jarr.search_batch(qs)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm_))
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
    np.testing.assert_array_equal(arr.best_match(qs).numpy(),
                                  np.asarray(jarr.best_match(qs)))
    assert bool(m[0, 2]) and int(arr.best_match(qs[0])[0]) == 2


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_nand_transition_counts_equal_reference(bits):
    """The NAND event counts of ``tests/test_nand_energy.py``'s arrays and
    queries (drawn by the reference and passed in), bitwise."""
    cfg = jcam.SEEMCAMConfig(bits=bits, n_cells=16, n_rows=1024,
                             variant="nand")
    codes = np.array(jax.random.randint(jax.random.PRNGKey(bits),
                                          (1024, 16), 0, cfg.levels))
    jarr = jcam.SEEMCAMArray(cfg)
    arr = cam_array.SEEMCAMArray(cam_array.SEEMCAMConfig(
        **dataclasses.asdict(cfg)), device=CPU)
    jarr.program(codes)
    arr.program(codes)
    for t in range(6):
        key = jax.random.fold_in(jax.random.PRNGKey(100 + bits), t)
        q = np.array(jax.random.randint(key, (16,), 0, cfg.levels))
        jarr.search(q)
        arr.search(q)
        assert arr.transition_count == jarr.transition_count
    arr.search(q)                             # repeating a query is free
    jarr.search(q)
    assert arr.transition_count == jarr.transition_count
    arr.program(codes)
    assert arr.transition_count == 0


def test_array_program_checks_and_variation():
    cfg = cam_array.SEEMCAMConfig(bits=2, n_cells=8, n_rows=4)
    arr = cam_array.SEEMCAMArray(cfg, device=CPU)
    with pytest.raises(RuntimeError, match="not programmed"):
        arr.codes
    with pytest.raises(ValueError, match="shape"):
        arr.program(np.zeros((3, 8), np.int32))
    with pytest.raises(ValueError, match="out of range"):
        arr.program(np.full((4, 8), 4))
    with pytest.raises(ValueError, match="variant"):
        cam_array.SEEMCAMConfig(variant="xor")
    codes = np.arange(32).reshape(4, 8) % 4
    arr.program(codes, generator=torch.Generator().manual_seed(1))
    assert arr._noise1.shape == (4, 8) and arr._noise2.shape == (4, 8)
    assert not torch.equal(arr._noise1, arr._noise2)
    # the variation is small against the ladder: exact rows still match
    assert bool(arr.search(codes[1]).match[1])


@pytest.mark.parametrize("bits", [1, 3])
def test_analog_search_batch_with_noise_matches_reference(bits,
                                                          monkeypatch):
    codes, qs = _codes_queries(bits, 30, 24, 9, 10 + bits)
    rng = np.random.default_rng(bits)
    n1 = (0.054 * rng.normal(size=codes.shape)).astype(np.float32)
    n2 = (0.054 * rng.normal(size=codes.shape)).astype(np.float32)
    jmm, jml = jcam.analog_search_batch(jnp.asarray(codes), jnp.asarray(qs),
                                        bits, n1, n2)
    args = (torch.from_numpy(codes), torch.from_numpy(qs), bits,
            torch.from_numpy(n1), torch.from_numpy(n2))
    mm, ml = cam_array.analog_search_batch(*args)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
    _allclose(ml, jml, rtol=1e-5)
    # query chunks of two leave every result unchanged
    monkeypatch.setattr(cam_array, "ANALOG_CHUNK_ELEMENTS", 2 * 30 * 24)
    mm2, ml2 = cam_array.analog_search_batch(*args)
    assert torch.equal(mm2, mm) and torch.equal(ml2, ml)


# ---------------------------------------------------------------------------
# analog backends of am
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["analog", "analog_cal"])
@pytest.mark.parametrize("distance", ["hamming", "l1"])
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_analog_backends_match_reference(backend, distance, bits):
    codes, qs = _codes_queries(bits, 40, 16, 12, 20 + bits)
    jt = jam.make_table(codes, bits=bits, distance=distance)
    t = am.make_table(codes, bits=bits, distance=distance, device=CPU)
    want = np.asarray(jam.distances(jt, qs, backend=backend))
    got = am.distances(t, qs, backend=backend)
    if distance == "hamming":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _allclose(got, want, rtol=1e-5)
    jr = jam.search(jt, qs, k=5, threshold=1.5, backend=backend)
    r = am.search(t, qs, k=5, threshold=1.5, backend=backend)
    _allclose(r.distances, jr.distances, rtol=1e-5)
    np.testing.assert_array_equal(r.exact.numpy(), np.asarray(jr.exact))
    # rows equal except at near-ties: where the rows differ, the port's
    # distance to the reference's row is within the tolerance of the
    # distance to its own
    full = got.numpy()
    gi, wi = r.indices.numpy(), np.asarray(jr.indices)
    rows = np.arange(len(qs))[:, None]
    differ = gi != wi
    assert np.allclose(full[rows, wi][differ], full[rows, gi][differ],
                       rtol=1e-5)


def test_analog_backend_with_variation_is_a_fixed_array():
    codes, qs = _codes_queries(3, 20, 16, 5, 7)
    t = am.make_table(codes, bits=3, distance="l1", device=CPU)
    gen = torch.Generator().manual_seed(11)
    fn = am.make_analog_backend(gen)
    a = am.distances(t, qs, backend=fn)
    torch.randn(5, generator=gen)            # the caller's generator moves on
    assert torch.equal(a, am.distances(t, qs, backend=fn))
    clean = am.distances(t, qs, backend="analog")
    assert not torch.equal(a, clean)
    # variation moves the analog distance, not the ranking of exact hits
    assert int(am.search(t, qs[0], backend=fn).best_row) == 2
    # the calibrated readout stays within half a level of digital L1 near 0
    digital = am.distances(t, qs, backend="ref")
    cal = am.distances(t, qs, backend="analog_cal")
    small = digital <= 8
    assert float((cal - digital).abs()[small].max()) < 0.5


def test_analog_backends_registered():
    assert am.backend_capabilities("analog") == ("dense",)
    assert am.backend_capabilities("analog_cal") == ("dense",)


# ---------------------------------------------------------------------------
# energy and baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_cells,bits", [(8, 1), (16, 2), (32, 3), (64, 3)])
def test_energy_model_equal(n_cells, bits):
    assert energy.model_summary(n_cells, bits) == \
        jenergy.model_summary(n_cells, bits)
    assert energy.energy_ratios(n_cells, bits) == \
        jenergy.energy_ratios(n_cells, bits)
    for fn in ("nor_search_energy_word", "nand_search_energy_word",
               "nand_expected_chain_events",
               "nand_expected_transitions_per_search"):
        assert getattr(energy, fn)(n_cells, bits) == \
            getattr(jenergy, fn)(n_cells, bits)
        assert getattr(energy, fn)(n_cells, bits, 0.3) == \
            getattr(jenergy, fn)(n_cells, bits, 0.3)
    for v in ("nor", "nand"):
        assert energy.search_energy_array(v, 128, n_cells, bits) == \
            jenergy.search_energy_array(v, 128, n_cells, bits)
        assert energy.search_latency(v, n_cells) == \
            jenergy.search_latency(v, n_cells)
    assert energy.fecam_ml_capacitance(n_cells) == \
        jenergy.fecam_ml_capacitance(n_cells)
    assert [dataclasses.asdict(d) for d in energy.TABLE_II] == \
        [dataclasses.asdict(d) for d in jenergy.TABLE_II]
    assert dataclasses.asdict(energy.THIS_WORK_NAND) == \
        dataclasses.asdict(jenergy.THIS_WORK_NAND)


def test_baselines_equal():
    for n in (8, 32, 64):
        assert baselines.fecam_energy_ratio(n) == jbase.fecam_energy_ratio(n)
        assert baselines.fecam_search_energy_word(n, 3) == \
            jbase.fecam_search_energy_word(n, 3)
    w = baselines.WILDCARD
    assert w == jbase.WILDCARD
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2, (9, 12))
    codes[rng.random((9, 12)) < 0.2] = w
    qs = rng.integers(0, 2, (5, 12))
    qs[0] = np.maximum(codes[4], 0)                   # matches row 4
    arr = baselines.FeFETTCAMArray(baselines.TCAMConfig(12, 9), device=CPU)
    jarr = jbase.FeFETTCAMArray(jbase.TCAMConfig(12, 9))
    arr.program(codes)
    jarr.program(codes)
    for g, want in zip(arr.search_batch(qs), jarr.search_batch(qs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert bool(arr.search_batch(qs)[0][0, 4])
    with pytest.raises(ValueError):
        arr.program(codes[:3])
