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
within the check's margin of a threshold and explains the difference.
"""

import ast
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import hdc, hdc_plain
from repro_torch.core import quantize as q
from repro_torch.data import hdc_data

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
