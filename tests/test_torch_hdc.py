"""Port parity: the HDC application against the JAX package, on the CPU.

Same numpy inputs through both packages; the reference's random draws (the
projection) are carried across with ``convert.hdc_model_from_numpy``.
Tolerances and why:

* datasets: bitwise (both are the same numpy code);
* encodings and fitted class hypervectors: rtol 1e-5, with an atol of 1e-5
  times the largest magnitude, since float32 sums taken in another order
  differ by a few ulps of the summands, not of a result near zero;
* quantized codes: at least 99.5 % of symbols equal and none off by more
  than one level (the reference's own kernel tolerance), since a value on a
  threshold may land on either side;
* predictions: at least 99 % of queries equal;
* ``encode_quantize``: the reference's kernel tolerance, against its Pallas
  kernel in interpret mode as ``tests/test_kernels.py`` runs it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hdc as jhdc
from repro.core import quantize as jq
from repro.data import hdc_data as jdata
from repro.kernels.hdc_encode import ops as j_enc_ops
from repro.kernels.hdc_encode import ref as j_enc_ref
from repro_torch import convert
from repro_torch.core import hdc
from repro_torch.data import hdc_data
from repro_torch.kernels.hdc_encode import ops as enc_ops
from repro_torch.kernels.hdc_encode import ref as enc_ref

torch.set_num_threads(2)

CPU = "cpu"


def _cut(spec, train=300, test=100):
    return dataclasses.replace(spec, train_size=train, test_size=test)


def _codes_agree(got, want, min_frac=0.995):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape
    assert (got == want).mean() >= min_frac, (got != want).mean()
    assert np.abs(got - want).max() <= 1


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def fitted():
    """Both packages' models fitted on the ucihar stand-in, cut to 300/100
    rows, at D = 256 from the reference's projection."""
    spec = _cut(jdata.TABLE_III["ucihar"])
    x_tr, y_tr, x_te, y_te = jdata.make_dataset(spec)
    jcfg = jhdc.HDCConfig(n_features=spec.n_features,
                          n_classes=spec.n_classes, dim=256,
                          retrain_epochs=3, bits=3)
    j0 = jhdc.make_model(jcfg)
    jm = jhdc.fit(j0, jnp.asarray(x_tr), jnp.asarray(y_tr))
    cfg = hdc.HDCConfig(**dataclasses.asdict(jcfg))
    t0 = convert.hdc_model_from_numpy(cfg, np.asarray(j0.projection),
                                      np.asarray(j0.class_hvs), device=CPU)
    tm = hdc.fit(t0, x_tr, y_tr)
    jhv = jhdc.encode(jm.projection, jnp.asarray(x_te))
    thv = hdc.encode(tm.projection, x_te)
    return dict(jm=jm, tm=tm, jhv=jhv, thv=thv, x_tr=x_tr, y_tr=y_tr,
                x_te=x_te, y_te=y_te)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["isolet", "ucihar", "pamap"])
def test_datasets_bitwise_equal(name):
    assert (dataclasses.asdict(hdc_data.TABLE_III[name])
            == dataclasses.asdict(jdata.TABLE_III[name]))
    spec = _cut(jdata.TABLE_III[name], 200, 50)
    got = hdc_data.make_dataset(hdc_data.DatasetSpec(
        **dataclasses.asdict(spec)))
    for g, w in zip(got, jdata.make_dataset(spec)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# model, training, inference
# ---------------------------------------------------------------------------

def test_encode_and_fit_match_reference(fitted):
    _close(fitted["thv"].numpy(), fitted["jhv"])
    assert fitted["thv"].dtype == torch.float32
    _close(fitted["tm"].class_hvs.numpy(), fitted["jm"].class_hvs)
    # one step at a time, from the same inputs
    hv = jhdc.encode(fitted["jm"].projection, jnp.asarray(fitted["x_tr"]))
    y = fitted["y_tr"]
    k, d = fitted["jm"].class_hvs.shape
    j1 = jhdc.train_single_pass(jnp.zeros((k, d)), hv, jnp.asarray(y))
    t1 = hdc.train_single_pass(torch.zeros((k, d)),
                               torch.tensor(np.asarray(hv)), y)
    _close(t1.numpy(), j1)
    _close(hdc.retrain_epoch(t1, torch.tensor(np.asarray(hv)), y,
                             0.03).numpy(),
           jhdc.retrain_epoch(j1, hv, jnp.asarray(y), 0.03))


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_quantized_codes_agree(fitted, bits):
    jm = dataclasses.replace(fitted["jm"], config=dataclasses.replace(
        fitted["jm"].config, bits=bits))
    tm = dataclasses.replace(fitted["tm"], config=dataclasses.replace(
        fitted["tm"].config, bits=bits))
    got = tm.quantized_class_codes()
    assert got.dtype == torch.int32
    _codes_agree(got.numpy(), jm.quantized_class_codes())
    _codes_agree(tm.quantize_queries(fitted["thv"]).numpy(),
                 jm.quantize_queries(fitted["jhv"]))


@pytest.mark.parametrize("bits", [1, 3])
def test_predictions_agree(fitted, bits):
    jm = dataclasses.replace(fitted["jm"], config=dataclasses.replace(
        fitted["jm"].config, bits=bits))
    tm = dataclasses.replace(fitted["tm"], config=dataclasses.replace(
        fitted["tm"].config, bits=bits))
    jhv, thv = fitted["jhv"], fitted["thv"]
    pairs = [
        (hdc.predict_cosine(tm.class_hvs, thv),
         jhdc.predict_cosine(jm.class_hvs, jhv)),
        (hdc.predict_cosine_quantized(tm.class_hvs, thv, bits),
         jhdc.predict_cosine_quantized(jm.class_hvs, jhv, bits)),
        (hdc.predict_cam(tm, thv), jhdc.predict_cam(jm, jhv)),
        (hdc.predict_cam(tm, thv, backend="cuda"),
         jhdc.predict_cam(jm, jhv, backend="pallas")),
        (hdc.predict_cam(tm, thv, distance="hamming"),
         jhdc.predict_cam(jm, jhv, distance="hamming")),
    ]
    for got, want in pairs:
        assert got.dtype == torch.int32
        assert (got.numpy() == np.asarray(want)).mean() >= 0.99
    # the port's CUDA backend (its plain path on the CPU) equals its ref
    assert torch.equal(hdc.predict_cam(tm, thv, backend="cuda"),
                       hdc.predict_cam(tm, thv))
    res = hdc.predict_cam_topk(tm, thv, 3)
    want = jhdc.predict_cam_topk(jm, jhv, 3)
    assert (res.indices.numpy() == np.asarray(want.indices)).mean() >= 0.99
    assert hdc.accuracy(hdc.predict_cam(tm, thv), fitted["y_te"]) == \
        pytest.approx(jhdc.accuracy(jhdc.predict_cam(jm, jhv),
                                    jnp.asarray(fitted["y_te"])), abs=0.011)


def test_make_model_is_seeded_and_on_the_requested_device():
    cfg = hdc.HDCConfig(n_features=7, n_classes=3, dim=32, seed=5)
    a, b = hdc.make_model(cfg, device=CPU), hdc.make_model(cfg, device=CPU)
    assert torch.equal(a.projection, b.projection)
    assert a.projection.shape == (7, 32) and a.projection.dtype == \
        torch.float32
    assert torch.count_nonzero(a.class_hvs) == 0
    c = hdc.make_model(dataclasses.replace(cfg, seed=6), device=CPU)
    assert not torch.equal(a.projection, c.projection)


def test_prompt_keys_match_reference():
    proj = np.array(jhdc.token_key_projection(50, 128))
    tokens = [3, 17, 17, 42, 0]
    want = jhdc.prompt_key(jnp.asarray(proj), tokens)
    got = hdc.prompt_key(torch.from_numpy(proj), tokens)
    assert got.dtype == torch.int32
    _codes_agree(got.numpy(), want)
    p = hdc.token_key_projection(50, 128, device=CPU)
    assert torch.equal(p, hdc.token_key_projection(50, 128, device=CPU))


def test_convert_checks_shapes():
    cfg = hdc.HDCConfig(n_features=4, n_classes=2, dim=8)
    with pytest.raises(ValueError, match="projection shape"):
        convert.hdc_model_from_numpy(cfg, np.zeros((4, 9)), np.zeros((2, 8)),
                                     device=CPU)
    with pytest.raises(ValueError, match="class_hvs shape"):
        convert.hdc_model_from_numpy(cfg, np.zeros((4, 8)), np.zeros((3, 8)),
                                     device=CPU)


# ---------------------------------------------------------------------------
# the fused encode + quantize (plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3])
@pytest.mark.parametrize("b,n,d", [
    (1, 4, 16), (5, 30, 100), (8, 128, 512), (130, 617, 1024), (64, 75, 333),
])
def test_encode_quantize_matches_reference(bits, b, n, d):
    rng = np.random.default_rng(b + n + d + bits)
    x = rng.normal(size=(b, n)).astype(np.float32)
    proj = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(j_enc_ops.encode_quantize(x, proj, bits,
                                                interpret=True))
    got = enc_ops.encode_quantize(torch.from_numpy(x), torch.from_numpy(proj),
                                  bits)
    assert got.dtype == torch.int32 and got.shape == (b, d)
    got = got.numpy()
    assert (got != want).mean() < 5e-3
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # and the port's plain version against the reference's oracle
    oracle = j_enc_ref.encode_quantize(x, proj, jq.gaussian_thresholds(bits))
    assert (got != np.asarray(oracle)).mean() < 5e-3


@pytest.mark.parametrize("seed", range(8))
def test_encode_quantize_scale_invariant(seed):
    rng = np.random.default_rng(seed)
    b, n, d = rng.integers(1, 17), rng.integers(2, 65), rng.integers(1, 129)
    bits = int(rng.integers(1, 4))
    x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
    proj = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    got = enc_ops.encode_quantize(x, proj, bits)
    assert got.shape == (b, d)
    assert int(got.min()) >= 0 and int(got.max()) < (1 << bits)
    # scaling the input row leaves codes invariant (Z-score normalisation)
    assert torch.equal(got, enc_ops.encode_quantize(3.7 * x, proj, bits))


def test_encode_quantize_levels_balanced():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    proj = torch.from_numpy(rng.normal(size=(256, 1024)).astype(np.float32))
    codes = enc_ops.encode_quantize(x, proj, 3).reshape(-1)
    freq = torch.bincount(codes, minlength=8).double() / codes.numel()
    np.testing.assert_allclose(freq.numpy(), 0.125, atol=0.02)


def test_encode_quantize_host_arrays_and_mixed_devices():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    proj = rng.normal(size=(6, 10)).astype(np.float32)
    got = enc_ops.encode_quantize(x, proj, 2, device=CPU)
    thr = torch.from_numpy(jq.gaussian_thresholds_np(2))
    assert torch.equal(got, enc_ref.encode_quantize(
        torch.from_numpy(x), torch.from_numpy(proj), thr))
    with pytest.raises(ValueError, match="x on"):
        enc_ops.encode_quantize(torch.from_numpy(x),
                                torch.zeros((6, 10), device="meta"), 2)


# ---------------------------------------------------------------------------
# the slice as a whole: Fig. 10 pipeline, port against reference
# ---------------------------------------------------------------------------

def test_pipeline_end_to_end_matches_reference():
    spec = _cut(jdata.TABLE_III["pamap"], 400, 150)
    x_tr, y_tr, x_te, y_te = hdc_data.make_dataset(
        hdc_data.DatasetSpec(**dataclasses.asdict(spec)))
    jcfg = jhdc.HDCConfig(n_features=spec.n_features,
                          n_classes=spec.n_classes, dim=128,
                          retrain_epochs=2, bits=3)
    j0 = jhdc.make_model(jcfg)
    jm = jhdc.fit(j0, jnp.asarray(x_tr), jnp.asarray(y_tr))
    tm = hdc.fit(convert.hdc_model_from_numpy(
        hdc.HDCConfig(**dataclasses.asdict(jcfg)), np.asarray(j0.projection),
        np.asarray(j0.class_hvs), device=CPU), x_tr, y_tr)
    jhv = jhdc.encode(jm.projection, jnp.asarray(x_te))
    thv = hdc.encode(tm.projection, x_te)
    for backend in ("ref", "cuda", "analog"):
        got = hdc.predict_cam(tm, thv, backend=backend).numpy()
        want = np.asarray(jhdc.predict_cam(
            jm, jhv, backend="pallas" if backend == "cuda" else backend))
        assert (got == want).mean() >= 0.99, backend
    acc = hdc.accuracy(hdc.predict_cam(tm, thv), y_te)
    assert acc > 1.5 / spec.n_classes        # well above chance
