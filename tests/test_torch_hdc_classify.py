"""The served HDC classifier (``hdc.classify``) against its plain float32
version (``core/hdc_plain.py``), on the CPU.

On the CPU the encode runs the kernel's plain version, one float32
product, as the plain classifier does, so the answers are equal, not close.
A query's answer depends on its own features alone.  On the ISOLET
stand-in, ``classify``'s per-row codes keep ``predict_cam``'s accuracy
(batch-wide codes) within 0.05.  Marked ``cuda`` (skipped without a card):
the fused kernel's answers at the benchmark cell's widths, held by the
benchmark's own check (``ambench/references/hdc_classify.py``): an answer
may differ from the plain version's only where a symbol's product lies
within the check's margin of a threshold and explains the difference; and
the replayed search (a CUDA graph a batch shape) bitwise the eager path,
its graph cache bounded, its results its callers' own, no sync after a
shape's first call, and the eager path while a profiler records.
"""

import ast
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import am, hdc, hdc_plain
from repro_torch.core import quantize as q
from repro_torch.data import hdc_data
from repro_torch.kernels.cam_search import kernel as cam_kernel
from repro_torch.kernels.hdc_encode import kernel as enc_kernel
from repro_torch.kernels.hdc_encode import ops as enc_ops

torch.set_num_threads(2)

N_FEATURES, N_CLASSES, DIM, QUERIES = 617, 26, 256, 64


def _inputs(seed, dim=DIM, queries=QUERIES, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((queries, N_FEATURES), generator=gen) * 3.0 + 0.5
    proj = torch.randn((N_FEATURES, dim), generator=gen)
    codes = torch.randint(0, 8, (N_CLASSES, dim), generator=gen,
                          dtype=torch.int32)
    return x.to(device), proj.to(device), codes.to(device)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("k", [1, 3])
def test_classify_equals_the_plain_version(backend, k):
    x, proj, codes = _inputs(k)
    clf = hdc.make_classifier(proj, codes, bits=3, device="cpu")
    got = hdc.classify(clf, x, k=k, backend=backend)
    ids, dists = hdc_plain.classify(x, proj, codes, k=k)
    assert torch.equal(got.indices.long(), ids)
    assert torch.equal(got.distances.double(), dists.double())
    assert clf.table.distance == "l1" and clf.table.bits == 3


def test_plain_encode_is_the_kernels_plain_version():
    from repro_torch.kernels.hdc_encode import ops
    x, proj, _ = _inputs(7)
    for bits in (1, 2, 3):
        assert torch.equal(hdc_plain.encode(x, proj, bits),
                           ops.encode_quantize(x, proj, bits))
        assert hdc_plain.THRESHOLDS[bits] == tuple(
            float(t) for t in q.gaussian_thresholds_np(bits))


def test_an_answer_does_not_depend_on_its_batchmates():
    x, proj, codes = _inputs(11)
    clf = hdc.make_classifier(proj, codes, device="cpu")
    whole = hdc.classify(clf, x, k=2)
    perm = torch.randperm(x.shape[0], generator=torch.Generator()
                          .manual_seed(3))
    shuffled = hdc.classify(clf, x[perm], k=2)
    assert torch.equal(shuffled.indices, whole.indices[perm])
    assert torch.equal(shuffled.distances, whole.distances[perm])
    for i in (0, 17, x.shape[0] - 1):
        alone = hdc.classify(clf, x[i:i + 1], k=2)
        assert torch.equal(alone.indices[0], whole.indices[i])
        # scaled batchmates move a batch-wide quantizer, not this one
        mates = torch.cat([x[i:i + 1], 40.0 * x[:5]])
        assert torch.equal(hdc.classify(clf, mates, k=2).indices[0],
                           whole.indices[i])


def test_a_classifier_checks_its_widths():
    x, proj, codes = _inputs(2)
    with pytest.raises(ValueError, match="width"):
        hdc.make_classifier(proj, codes[:, :100], device="cpu")


def test_accuracy_on_the_isolet_standin_is_predict_cams():
    spec = hdc_data.TABLE_III["isolet"]
    x_tr, y_tr, x_te, y_te = hdc_data.make_dataset(spec)
    cfg = hdc.HDCConfig(n_features=spec.n_features,
                        n_classes=spec.n_classes, dim=1024, retrain_epochs=2)
    model = hdc.fit(hdc.make_model(cfg, device="cpu"), x_tr, y_tr)
    clf = hdc.make_classifier(model.projection, model.quantized_class_codes(),
                              bits=cfg.bits)
    served = hdc.accuracy(hdc.classify(clf, x_te).best_row, y_te)
    batch = hdc.accuracy(hdc.predict_cam(model, hdc.encode(
        model.projection, x_te), backend="cuda"), y_te)
    assert served > 0.7
    assert abs(served - batch) <= 0.05


def test_the_plain_version_imports_nothing_of_the_port():
    path = Path(hdc_plain.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "torch"}


@pytest.mark.parametrize("bits", range(1, 9))
def test_the_threshold_cache_holds_the_numpy_thresholds(bits):
    thr = enc_ops.thresholds(bits, "cpu")
    assert thr.dtype == torch.float32 and thr.device.type == "cpu"
    assert np.array_equal(thr.numpy(), q.gaussian_thresholds_np(bits))
    assert enc_ops.thresholds(bits, torch.device("cpu")) is thr


def test_a_cpu_classifier_takes_no_graph_path():
    x, proj, codes = _inputs(4)
    clf = hdc.make_classifier(proj, codes, device="cpu")
    first = hdc.classify(clf, x, k=2)
    again = hdc.classify(clf, x, k=2)
    assert clf._graphs == {}
    assert torch.equal(first.indices, again.indices)


def test_hdc_encode_checks_its_out_as_its_inputs(monkeypatch):
    """``out`` goes through the inputs' check: int32, (B, D), x's device,
    contiguous.  A recording check stands in for the CUDA-only one and
    stops the call at ``out``, before any launch."""
    seen = {}

    class Stop(Exception):
        pass

    def record(name, t, dtype, shape, device, align=1):
        seen[name] = (t, dtype, tuple(shape), device, align)
        if name == "out":
            raise Stop

    monkeypatch.setattr(enc_kernel, "check", record)
    x, proj = torch.zeros((5, 7)), torch.zeros((7, 12))
    thr = enc_ops.thresholds(3, "cpu")
    out = torch.empty((5, 12), dtype=torch.int32)
    with pytest.raises(Stop):
        enc_kernel.hdc_encode(x, proj, thr, out=out)
    assert set(seen) == {"x", "proj", "thresholds", "out"}
    assert seen["out"][0] is out
    assert seen["out"][1:] == (torch.int32, (5, 12), x.device, 1)
    assert seen["x"][3:] == seen["out"][3:]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="x must be a CUDA tensor"):
        enc_kernel.hdc_encode(x, proj, thr, out=out)
    assert enc_kernel.launches == {"hdc_encode": 0}


# -- the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _benchmark_reference():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from ambench.references import hdc_classify
    return hdc_classify


@pytest.mark.cuda
def test_the_fused_path_at_the_cells_widths(dev):
    reference = _benchmark_reference()
    x, proj, codes = _inputs(5, dim=4096, queries=1024, device=dev)
    clf = hdc.make_classifier(proj, codes, device=dev)
    got = hdc.classify(clf, x, k=3, backend="cuda")
    ids, dists = hdc_plain.classify(x, proj, codes, k=3)
    want = reference.expected(
        types.SimpleNamespace(codes=codes, projection=proj), x,
        {"table": {"bits": 3}}, 3, dev)
    assert np.array_equal(want["indices"], ids.cpu().numpy())
    assert np.array_equal(want["distances"], dists.cpu().double().numpy())
    answers = [reference.Answer(i, d) for i, d in
               zip(got.indices.cpu().numpy(), got.distances.cpu().numpy())]
    # a difference counts unless a symbol on a threshold explains it
    assert reference.mismatched(answers, want) == 0


#: The benchmark cell's widths: 4,096 rows a batch of 617 features, D =
#: 4,096, 26 classes, 3 bits, L1; and a job's ragged last batch.
CELL_B, RAGGED_B = 4096, 1000


def _cell(dev, seed=5):
    _, proj, codes = _inputs(seed, dim=4096, queries=1, device=dev)
    return hdc.make_classifier(proj, codes, device=dev)


def _features(seed, b, dev):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((b, N_FEATURES), generator=gen) * 3.0 + 0.5).to(dev)


def _eager(clf, x, k):
    """What ``classify`` runs without a graph."""
    codes = enc_ops.encode_quantize(x, clf.projection, clf.table.bits)
    return am.search(clf.table, codes, k=k, backend="cuda")


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("indices", "distances", "exact", "matched"))


def _counts():
    return {**cam_kernel.launches, **enc_kernel.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [CELL_B, RAGGED_B])
def test_the_replay_is_the_eager_path_bitwise(dev, b):
    """Five batches of other features after the shape's first call (eager,
    then the capture): answers and launch counts those of eager calls."""
    clf = _cell(dev)
    one_call = {"hdc_encode": 1, "cam_pack_l1": 1, "cam_search_topk": 1,
                "cam_search_topk_few": 1}
    for k in (1, 3):
        hdc.classify(clf, _features(k, b, dev), k=k)
        assert (b, k, "cuda") in clf._graphs
        for step in range(5):
            x = _features(100 * k + step, b, dev)
            want = _eager(clf, x, k)
            cam_kernel.reset_launches()
            enc_kernel.reset_launches()
            got = hdc.classify(clf, x, k=k)
            assert _same(got, want), (b, k, step)
            assert got.matched is got.exact
            assert got.indices.shape == (b, k)
            assert _counts() == {**dict.fromkeys(_counts(), 0), **one_call}


@pytest.mark.cuda
def test_the_graph_cache_keeps_its_bound(dev):
    clf = _cell(dev)
    shapes = [(64, 1), (96, 1), (64, 2), (128, 1), (96, 1)]
    for i, (b, k) in enumerate(shapes * 2):
        x = _features(i, b, dev)
        assert _same(hdc.classify(clf, x, k=k), _eager(clf, x, k))
        assert len(clf._graphs) <= hdc.GRAPHS_MAX
    assert set(clf._graphs) == {(64, 1, "cuda"), (96, 1, "cuda")}


@pytest.mark.cuda
def test_a_result_outlives_the_next_call(dev):
    clf = _cell(dev)
    x1, x2 = _features(1, 256, dev), _features(2, 256, dev)
    hdc.classify(clf, x2, k=2)                            # the capture
    first = hdc.classify(clf, x1, k=2)
    kept = {f: getattr(first, f).clone()
            for f in ("indices", "distances", "exact")}
    second = hdc.classify(clf, x2, k=2)
    torch.cuda.synchronize()
    assert all(torch.equal(getattr(first, f), v) for f, v in kept.items())
    assert not torch.equal(first.indices, second.indices)
    assert first.indices.data_ptr() != second.indices.data_ptr()


@pytest.mark.cuda
def test_no_sync_after_a_shapes_first_call(dev):
    clf = _cell(dev)
    shapes = [(CELL_B, 1), (RAGGED_B, 1), (512, 1)]     # the last eager
    xs = {s: _features(i, s[0], dev) for i, s in enumerate(shapes)}
    for (b, k), x in xs.items():
        hdc.classify(clf, x, k=k)
    assert len(clf._graphs) == 2 and (512, 1, "cuda") not in clf._graphs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            for (b, k), x in xs.items():
                hdc.classify(clf, x, k=k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_profiled_call_takes_the_eager_path(dev, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    clf = _cell(dev)
    x = _features(3, 512, dev)
    want = hdc.classify(clf, x, k=1)
    assert (512, 1, "cuda") in clf._graphs
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = hdc.classify(clf, x, k=1)
    torch.cuda.synchronize()
    assert _same(got, want)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"hdc.classify", "hdc.encode", "am.search", "cam.expand.l1",
            "cam.topk"} <= names
    c = obs.counters()
    assert c["cam_topk.launches"] == 1 and c["cam_topk.traced_launches"] == 1
    assert c["cam_topk.votes"] == 512        # one vote a query, one tile
    obs.reset()


@pytest.mark.cuda
def test_hdc_encode_writes_into_a_checked_out(dev):
    x, proj = _features(6, 300, dev), _inputs(6, dim=512, device=dev)[1]
    thr = enc_ops.thresholds(3, dev)
    want = enc_kernel.hdc_encode(x, proj, thr)
    out = torch.full((300, 512), -1, dtype=torch.int32, device=dev)
    assert enc_kernel.hdc_encode(x, proj, thr, out=out) is out
    assert torch.equal(out, want)
    bad = {"must be torch.int32": out.to(torch.int64),
           "shape": out[:299],
           "contiguous": torch.empty((512, 300), dtype=torch.int32,
                                     device=dev).t(),
           "CUDA": out.cpu()}
    for match, o in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            enc_kernel.hdc_encode(x, proj, thr, out=o)
