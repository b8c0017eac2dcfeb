"""The HDC classifier's cell (``hdc_isolet_d4096.bulk_k1``): whole runs at
a tiny size on the CPU, faults and lower precisions the check has to catch,
the reference against the port's plain version, the frozen stand-in, the
encode roofline's arithmetic; and a short run on the card."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ambench import control, registry, run, traffic  # noqa: E402
from ambench.frozen import hdc_peaks, hdc_standin  # noqa: E402

CELL = "hdc_isolet_d4096.bulk_k1"
#: A tiny population at the cell's widths, and small batches.
TINY = {"population": 2048}
TINY_MIX = {"batch_lookups": 128, "batches_in_flight": 2,
            "warmup_batches": 2}


@pytest.fixture(autouse=True)
def _hide_jax(monkeypatch):
    """Other test files load JAX and ``repro`` into this worker; a run
    refuses to report once it sees them, so they are hidden here."""
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)


def _module(kind):
    bench = registry.benchmark()
    cfg = registry.config(bench, registry.cell(bench, CELL)["config"])
    return registry.module(kind, cfg[kind[:-1] if kind == "references"
                                     else "system"])


def _cfg_mix():
    bench = registry.benchmark()
    cell = registry.cell(bench, CELL)
    cfg = run._update(registry.config(bench, cell["config"]), dict(TINY))
    mix = run._update(registry.traffic(cell["traffic"]), dict(TINY_MIX))
    return cfg, mix


def _run(seed=2**31 + 21, trace=False, dim=None):
    over = dict(TINY)
    if dim is not None:
        over["table"] = {"dim": dim}
    return run.run_cell(CELL, seed, 0.3, trace, need_card=False,
                        device="cpu", config_over=over, mix_over=TINY_MIX)


# -- whole runs ---------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_is_correct_with_the_contract_keys(trace):
    out = _run(trace=trace, dim=512)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["mismatched_answers"] == {"value": 0, "limit": 0}
    assert out["window"]["dispatched"] == 128 * out["window"]["groups"]
    if not trace:
        assert {"lookups_per_s", "setup_s"} <= set(out["metrics"])
    else:
        # the per-layer readers find no kernel on the CPU and say nothing,
        # but the idle share: no device work ran in the slice
        assert out["metrics"] == {"device_idle_pct.bulk": {
            "value": 100.0, "unit": "%"}}


def test_the_cell_is_wired_into_the_benchmark():
    bench = registry.benchmark()
    names = lambda t: {m["name"] for m in registry.metrics(bench, CELL, t)}
    assert names(False) == {"lookups_per_s", "peak_mem_gib", "setup_s"}
    assert {"hdc_encode_roofline", "l1_expand_span_pct",
            "hdc_encode_span_pct"} <= names(True)
    # the readers of the search path it shares with the row tables
    assert {"device_idle_pct.bulk", "search_host_idle_pct",
            "cam_topk_select_pct", "cam_topk_insert_pct",
            "cam_topk_keys_per_insert", "table_cast_pct",
            "table_cast_span_pct"} <= names(True)
    # those two read ``table.width``, which a classifier has not
    assert not {"cam_search_topk_roofline", "search_mfu"} & names(True)
    assert registry.cell(bench, CELL)["chips"] == 1


@pytest.mark.parametrize("fault", ["class", "distance"])
def test_a_planted_wrong_answer_is_not_correct(monkeypatch, fault):
    from repro_torch.core import am, hdc
    classify = hdc.classify

    def broken(clf, x, k=1, **kw):
        r = classify(clf, x, k=k, **kw)
        idx, dist = r.indices.clone(), r.distances.clone()
        if fault == "class":
            idx[::7, 0] = (idx[::7, 0] + 1) % clf.table.n_rows
        else:
            dist[:, 0] += 1
        return am.AMSearchResult(idx, dist, r.exact, r.matched)

    monkeypatch.setattr(hdc, "classify", broken)
    out = _run(dim=512)
    assert not out["correct"]
    assert out["checks"]["mismatched_answers"]["value"] > 0


def test_the_control_fails_the_check():
    row = control.reading(CELL, 3, "cpu", config_over=dict(TINY),
                          mix_over=dict(TINY_MIX))
    assert row["control_mismatched"] > row["checked"] // 2


# -- precisions the check tells apart --------------------------------------------

def _answers_from_codes(codes, classes, reference):
    d = (codes.long()[:, None, :] - classes.long()[None]).abs().sum(dim=-1)
    n = d.shape[1]
    key = (d * n + torch.arange(n)).min(dim=1).values.numpy()
    return [reference.Answer([k % n], [k // n]) for k in key]


@pytest.fixture(scope="module")
def checked_features():
    """The cell's inputs at its widths and 512 of its features."""
    cfg, mix = _cfg_mix()
    inputs = _module("systems").make_inputs(
        cfg, mix, traffic.seeds(2**32 + 3)["rows"], "cpu")
    keys = np.random.default_rng(4).integers(0, inputs.words.shape[0], 512)
    return cfg, inputs, inputs.words[torch.as_tensor(keys)]


@pytest.mark.parametrize("terms,fails", [(1, True), (3, False)])
def test_single_tf32_answers_fail_the_check(checked_features, terms, fails):
    """The check takes the kernel's 3xTF32 product (emulated) and refuses
    a single TF32 product's answers."""
    from repro_torch.core import quantize
    from repro_torch.kernels.hdc_encode import ref
    cfg, inputs, x = checked_features
    reference = _module("references")
    want = reference.expected(inputs.stored, x, cfg, 1, "cpu")
    thr = quantize.gaussian_thresholds(3)
    codes = ref.codes_from_product(
        ref.tf32_product(x, inputs.stored.projection, terms=terms), x, thr)
    bad = reference.mismatched(_answers_from_codes(
        codes, inputs.stored.codes, reference), want)
    if fails:
        assert bad > x.shape[0] // 10
    else:
        assert bad == 0


def test_the_reference_is_the_ports_plain_version():
    from repro_torch.core import hdc_plain
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((300, hdc_standin.FEATURES), generator=gen) * 4.0
    proj = torch.randn((hdc_standin.FEATURES, 384), generator=gen)
    codes = torch.randint(0, 8, (hdc_standin.CLASSES, 384), generator=gen,
                          dtype=torch.int32)
    stored = _module("systems").Model(codes, proj)
    cfg, _ = _cfg_mix()
    want = _module("references").expected(stored, x, cfg, 4, "cpu")
    ids, dists = hdc_plain.classify(x, proj, codes, k=4)
    assert np.array_equal(want["indices"], ids.numpy())
    assert np.array_equal(want["distances"], dists.numpy().astype(float))
    assert hdc_standin.THRESHOLDS_3BIT == hdc_plain.THRESHOLDS[3]


def test_the_control_is_a_single_tf32_product(checked_features):
    """The reference's control codes (``bits`` below the configuration's)
    are the port's emulated single TF32 product's, bit for bit."""
    from repro_torch.core import quantize
    from repro_torch.kernels.hdc_encode import ref
    _, inputs, x = checked_features
    proj = inputs.stored.projection
    reference = _module("references")
    got = reference.codes(x, proj, single_tf32=True)[0]
    want = ref.codes_from_product(ref.tf32_product(x, proj, terms=1), x,
                                  quantize.gaussian_thresholds(3))
    assert torch.equal(got.int(), want)
    assert not torch.equal(got, reference.codes(x, proj)[0])


def test_an_ambiguous_symbol_explains_only_its_own_moves():
    reference = _module("references")
    class_d = np.array([10, 11, 30])
    moves = np.array([[1, -1, 1]])       # the other code: 11, 10, 31
    explained = lambda i, d, m=moves: reference._explained(
        np.array([i]), np.array([float(d)]), class_d, m)
    assert explained(1, 10)
    assert not explained(0, 11)          # not the nearest either way
    assert not explained(2, 30)
    assert not explained(0, 12)
    assert not explained(1, 10, moves[:0])


# -- the frozen stand-in and arithmetic -----------------------------------------

def test_the_frozen_standin_is_hdc_datas_isolet_bitwise():
    from repro_torch.core import quantize
    from repro_torch.data import hdc_data
    spec = hdc_data.TABLE_III["isolet"]
    assert (spec.n_features, spec.n_classes, spec.train_size, spec.test_size,
            spec.noise, spec.seed) == (
        hdc_standin.FEATURES, hdc_standin.CLASSES, hdc_standin.TRAIN_ROWS,
        hdc_standin.TEST_ROWS, hdc_standin.NOISE, hdc_standin.SEED)
    got = hdc_standin.dataset()
    want = hdc_data.make_dataset(spec)
    for a, b in zip((got["x_train"], got["y_train"], got["x_test"],
                     got["y_test"]), want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.Generator(np.random.PCG64(spec.seed))
    assert np.array_equal(got["centers"], rng.normal(
        0, 1, (spec.n_classes, spec.n_features)))
    assert np.array_equal(got["mix"], rng.normal(
        0, 1, (spec.n_features, spec.n_features)) / np.sqrt(spec.n_features))
    assert np.asarray(hdc_standin.THRESHOLDS_3BIT, np.float32).tobytes() == \
        quantize.gaussian_thresholds_np(3).tobytes()


def test_class_codes_are_the_ports_quantized_class_codes():
    """The benchmark's class codes: one pass of the stand-in's training
    rows and the whole-matrix Z quantizer, as ``HDCModel`` makes them (up
    to symbols on a threshold, float64 against float32 sums)."""
    from repro_torch.core import hdc
    systems = _module("systems")
    data = hdc_standin.dataset()
    proj = systems.projection(hdc_standin.FEATURES, 512, 7)
    got = systems.class_codes(proj, data)
    cfg = hdc.HDCConfig(n_features=hdc_standin.FEATURES,
                        n_classes=hdc_standin.CLASSES, dim=512,
                        retrain_epochs=0)
    model = hdc.HDCModel(cfg, torch.from_numpy(proj),
                         torch.zeros((cfg.n_classes, cfg.dim)))
    model = hdc.fit(model, data["x_train"], data["y_train"])
    want = model.quantized_class_codes().numpy()
    assert (got == want).mean() > 0.999
    assert np.abs(got - want).max() <= 1


def test_the_encode_roofline_on_a_synthetic_record():
    read = registry.module("metrics", "hdc_encode_roofline").read
    rec = {"config": {"table": {"features": 617, "dim": 4096}},
           "counters": {"groups": 10, "dispatched": 40960},
           "trace": {"device_ops_s": {"hdc_encode_kernel": 0.01,
                                      "other": 5.0}}}
    ops = 3 * 2 * 4096 * 617 * 4096
    assert hdc_peaks.encode_ops(4096, 617, 4096) == ops
    assert ops / 4.95e14 > hdc_peaks.encode_bytes(4096, 617, 4096) / 3.35e12
    assert read(rec) == pytest.approx(100 * 10 * ops / 4.95e14 / 0.01)
    assert read({**rec, "trace": None}) is None
    assert read({**rec, "trace": {"device_ops_s": {}}}) is None


# -- the card ---------------------------------------------------------------------

@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run.run_cell(CELL, 2**31 + 9, 2.0, False, config_over=dict(TINY))
    assert out["correct"] and out["device"]["platform"] == "gpu"
