"""``repro_torch.obs``: spans and in-kernel counters, on only while a
profiler records.

On the CPU: the shared no-op span without a profiler; the search, index,
driver and HDC classify spans nested in an exported trace; counters that
stay zero.
The launches traced, one in ``obs.TRACE_EVERY``, and the counters scaled
to all of them.  Marked ``cuda`` (skipped without a card; run on the card
with ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_obs.py``): the kernel path's spans, the L1 pack placed
under ``cam.expand.l1``, and the traced partial
pass of the fused top-k at the bulk cells' shape and its few-row pass at
the HDC cell's, each bitwise the untraced pass, with exact vote counts.
"""

import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import am, hdc
from repro_torch.index import ivf
from repro_torch.kernels import _build
from repro_torch.kernels.cam_search import kernel
from repro_torch.serve import AMService

torch.set_num_threads(2)


def _codes(n, d, seed=0):
    return np.random.default_rng(seed).integers(0, 8, (n, d)).astype(np.int32)


def _annotations(prof, tmp_path):
    """name -> [(thread, start, end)] of the profile's ``record_function``
    ranges, from its exported Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append(
                (e["tid"], e["ts"], e["ts"] + e["dur"]))
    return out


def _inside(spans, inner, outer):
    """Every ``inner`` range lies in some ``outer`` range of its thread."""
    assert spans.get(inner), f"no {inner} span"
    return all(any(t == u and a <= c and d <= b
                   for u, a, b in spans.get(outer, []))
               for t, c, d in spans[inner])


def test_span_is_the_shared_noop_without_a_profiler():
    assert not obs.enabled()
    assert obs.span("am.search") is obs.span("cam.topk")
    with obs.span("am.search"):
        pass


def test_counters_stay_zero_without_a_profiler():
    obs.reset()
    table = am.make_table(_codes(300, 16), device="cpu")
    for backend in ("ref", "cuda"):
        am.search(table, _codes(5, 16, 1), k=4, backend=backend)
    c = obs.counters()
    assert set(c) == {"cam_topk.votes", "cam_topk.inserts",
                      "cam_topk.cycles_compare", "cam_topk.cycles_select",
                      "cam_topk.offered", "cam_topk.launches",
                      "cam_topk.traced_launches"}
    assert all(v == 0 for v in c.values())


def test_one_launch_in_trace_every_is_traced_and_counters_scale():
    obs.reset()
    made = 2 * obs.TRACE_EVERY + 3
    bufs = [obs.launch_buffer("cam_topk", "cpu") for _ in range(made)]
    traced = [b for b in bufs if b is not None]
    assert [i for i, b in enumerate(bufs) if b is not None] == [
        0, obs.TRACE_EVERY, 2 * obs.TRACE_EVERY]
    assert all(b is traced[0] for b in traced)
    for b in traced:                  # what each traced launch would add
        b += torch.tensor([128, 12, 300, 100, 40])
    c = obs.counters()
    assert c["cam_topk.launches"] == made
    assert c["cam_topk.traced_launches"] == 3
    assert c["cam_topk.votes"] == 128 * made
    assert c["cam_topk.inserts"] == 12 * made
    assert c["cam_topk.cycles_compare"] == 300 * made
    assert c["cam_topk.cycles_select"] == 100 * made
    assert c["cam_topk.offered"] == 40 * made
    obs.reset()
    assert all(v == 0 for v in obs.counters().values())


def test_counter_fields_are_in_the_order_the_kernel_writes_them():
    """``obs.COUNTERS["cam_topk"]`` names the words of the traced partial
    pass's ``stats`` buffer: the ``TopkStat`` enum of ``cam_search.cu``
    (``kCyclesCompare`` is ``cycles_compare``), in its order."""
    src = (_build.CSRC / "cam_search.cu").read_text()
    body = re.search(r"enum TopkStat \{([^}]*)\}", src).group(1)
    fields = tuple(re.sub(r"(?<!^)([A-Z])", r"_\1", name.strip()[1:]).lower()
                   for name in body.split(","))
    assert fields == obs.COUNTERS["cam_topk"]


@pytest.mark.parametrize("backend,children", [
    ("ref", ["am.search.prep"]),
    ("cuda", ["am.search.prep", "cam.cast.queries", "cam.cast.table"]),
])
def test_search_spans_nest_under_a_cpu_profiler(backend, children,
                                                tmp_path):
    table = am.make_table(_codes(300, 16), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.enabled()
        am.search(table, _codes(5, 16, 1), k=4, backend=backend)
    assert not obs.enabled()
    spans = _annotations(prof, tmp_path)
    assert len(spans["am.search"]) == 1
    for child in children:
        assert _inside(spans, child, "am.search"), child


def _classifier(dim=64, device="cpu"):
    gen = torch.Generator().manual_seed(dim)
    proj = torch.randn((40, dim), generator=gen)
    codes = torch.randint(0, 8, (6, dim), generator=gen, dtype=torch.int32)
    x = torch.randn((9, 40), generator=gen)
    return hdc.make_classifier(proj.to(device), codes, device=device), \
        x.to(device)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_hdc_classify_spans_nest_under_a_cpu_profiler(backend, tmp_path):
    clf, x = _classifier()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hdc.classify(clf, x, k=2, backend=backend)
    spans = _annotations(prof, tmp_path)
    assert len(spans["hdc.classify"]) == 1
    assert len(spans["cam.expand.l1"]) == 1
    assert _inside(spans, "hdc.encode", "hdc.classify")
    assert _inside(spans, "am.search", "hdc.classify")
    assert _inside(spans, "cam.expand.l1", "am.search")
    assert not _inside(spans, "cam.expand.l1", "hdc.encode")


def test_hdc_and_l1_spans_cost_nothing_without_a_profiler(monkeypatch,
                                                          tmp_path):
    """No ``record_function`` is made outside a profiler; a Hamming table
    expands nothing, so it has no ``cam.expand.l1`` span under one."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) unprofiled")

    clf, x = _classifier()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    hdc.classify(clf, x, k=2, backend="cuda")
    monkeypatch.undo()
    hamming = am.make_table(_codes(50, 16), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        am.search(hamming, _codes(3, 16, 1), k=2, backend="cuda")
    assert "cam.expand.l1" not in _annotations(prof, tmp_path)


def test_index_and_driver_spans(tmp_path):
    codes = _codes(512, 16)
    index = ivf.build(am.make_table(codes, device="cpu"), sets=8)
    svc = AMService(device="cpu", max_batch=1 << 20)
    svc.create_table("t", width=16, capacity=64, backend="cuda")
    svc.append("t", codes[:64])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ivf.search(index, codes[:6], k=3, probes=2)
        futs = [svc.submit("t", codes[i]) for i in range(6)]
        svc.flush()
    assert all(f.result().hit for f in futs)
    spans = _annotations(prof, tmp_path)
    for stage in ("ivf.coarse", "ivf.fine", "ivf.merge",
                  "am.driver.launch", "am.driver.resolve"):
        assert len(spans.get(stage, [])) == 1, stage
    assert _inside(spans, "am.search", "am.driver.launch")
    assert "am.driver.readback" not in spans       # no CUDA event here


# -- the card ---------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_search_spans(dev, tmp_path):
    table = am.make_table(_codes(5000, 128), device=dev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        am.search(table, _codes(64, 128, 1), k=10, backend="cuda")
        torch.cuda.synchronize()
    spans = _annotations(prof, tmp_path)
    for child in ("am.search.prep", "cam.cast.queries", "cam.cast.table",
                  "cam.pack", "cam.topk"):
        assert _inside(spans, child, "am.search"), child


@pytest.mark.cuda
def test_card_hdc_classify_spans(dev, tmp_path):
    clf, x = _classifier(dim=4096, device=dev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hdc.classify(clf, x, k=1, backend="cuda")
        torch.cuda.synchronize()
    spans = _annotations(prof, tmp_path)
    assert _inside(spans, "hdc.encode", "hdc.classify")
    for child in ("cam.expand.l1", "cam.topk"):
        assert _inside(spans, child, "am.search"), child
    assert "cam.pack" not in spans          # the L1 pack runs in its place


def _kernels_by_span(prof, tmp_path):
    """kernel name -> names of the spans that hold, on the same thread,
    the runtime or driver call that launched it (matched by
    ``correlation``), from the profile's exported Chrome trace."""
    path = tmp_path / "device_trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        call = calls[e["args"]["correlation"]]
        out.setdefault(e["name"], set()).update(
            s["name"] for s in spans if s["tid"] == call["tid"]
            and s["ts"] <= call["ts"] <= s["ts"] + s["dur"])
    return out


@pytest.mark.cuda
def test_card_l1_pack_runs_in_the_expand_span(dev, tmp_path):
    """An L1 search's pack is one ``cam_pack_l1_kernel`` launched inside
    ``cam.expand.l1`` (what ``l1_expand_span_pct`` reads), and nothing is
    launched inside ``cam.pack``."""
    codes = _codes(300, 4096)
    table = am.make_table(codes, bits=3, distance="l1", device=dev)
    am.search(table, codes[:8], k=1, backend="cuda")       # load the library
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        am.search(table, codes[:64], k=1, backend="cuda")
        torch.cuda.synchronize()
    placed = _kernels_by_span(prof, tmp_path)
    packs = [name for name in placed if "cam_pack_l1_kernel" in name]
    assert len(packs) == 1, sorted(placed)
    assert {"cam.expand.l1", "am.search"} <= placed[packs[0]]
    assert all("cam.pack" not in where for where in placed.values())
    assert not any("cam_pack_kernel" in name for name in placed)


#: The bulk cells' shape: a batch of 1,024 lookups of 128 3-bit symbols
#: against 2^20 rows.
CELL_Q, CELL_N, CELL_D = 1024, 1 << 20, 128


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 100])
def test_traced_partial_pass_is_bitwise_and_counts_every_vote(dev, k):
    gen = torch.Generator(device=dev).manual_seed(k)
    table = torch.randint(0, 8, (CELL_N, CELL_D), generator=gen, device=dev,
                          dtype=torch.int8)
    queries = table[torch.randint(0, CELL_N, (CELL_Q,), generator=gen,
                                  device=dev)].clone()
    queries[::2, :4] = (queries[::2, :4] + 1) % 8
    vr = torch.full((1,), CELL_N, dtype=torch.int32, device=dev)

    def search():
        return kernel.cam_search_topk(queries, table, vr, levels=8, k=k)

    obs.reset()
    idx, dist = search()
    torch.cuda.synchronize()
    assert all(v == 0 for v in obs.counters().values())
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):            # the first traced, the second not
            t_idx, t_dist = search()
            assert torch.equal(t_idx, idx) and torch.equal(
                t_dist.view(torch.int32), dist.view(torch.int32))
        torch.cuda.synchronize()
    c = obs.counters()
    assert c["cam_topk.launches"] == 2 and c["cam_topk.traced_launches"] == 1
    votes = CELL_Q * -(-CELL_N // 128)
    assert c["cam_topk.votes"] == 2 * votes
    assert 0 <= c["cam_topk.inserts"] <= c["cam_topk.votes"]
    assert c["cam_topk.cycles_compare"] > 0
    assert c["cam_topk.cycles_select"] > 0
    # every vote that inserts offers a key, and only those offer keys
    assert c["cam_topk.offered"] >= c["cam_topk.inserts"]
    assert (c["cam_topk.offered"] == 0) == (c["cam_topk.inserts"] == 0)
    search()
    torch.cuda.synchronize()
    assert obs.counters() == c                  # off again
    obs.reset()
    assert all(v == 0 for v in obs.counters().values())


#: The HDC cell's search: a batch of 4,096 queries against its 26 class
#: rows of 4,096 3-bit codes, at L1 distance.
HDC_Q, HDC_N, HDC_D = 4096, 26, 4096


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, HDC_N])
def test_traced_few_row_pass_is_bitwise_and_counts_every_vote(dev, k):
    """The few-row partial pass (a table of at most 32 rows) at the HDC
    cell's shape: the traced launch bitwise the untraced one, one vote a
    query (one tile), every vote inserting into its open list and offering
    it all 26 keys."""
    gen = torch.Generator(device=dev).manual_seed(k)
    table = torch.randint(0, 8, (HDC_N, HDC_D), generator=gen, device=dev,
                          dtype=torch.int8)
    queries = torch.randint(0, 8, (HDC_Q, HDC_D), generator=gen, device=dev,
                            dtype=torch.int8)
    queries[:HDC_N] = table                      # an exact hit each
    vr = torch.full((1,), HDC_N, dtype=torch.int32, device=dev)

    def search():
        return kernel.cam_search_topk(queries, table, vr, levels=8, k=k,
                                      l1=True)

    obs.reset()
    kernel.reset_launches()
    idx, dist = search()
    torch.cuda.synchronize()
    assert all(v == 0 for v in obs.counters().values())
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):            # the first traced, the second not
            t_idx, t_dist = search()
            assert torch.equal(t_idx, idx) and torch.equal(
                t_dist.view(torch.int32), dist.view(torch.int32))
        torch.cuda.synchronize()
    assert torch.equal(idx[:HDC_N, 0].cpu(), torch.arange(HDC_N,
                                                          dtype=torch.int32))
    c = obs.counters()
    assert c["cam_topk.launches"] == 2 and c["cam_topk.traced_launches"] == 1
    assert c["cam_topk.votes"] == c["cam_topk.inserts"] == 2 * HDC_Q
    assert c["cam_topk.offered"] == 2 * HDC_Q * HDC_N
    assert c["cam_topk.cycles_compare"] > 0
    assert c["cam_topk.cycles_select"] > 0
    assert kernel.launches["cam_search_topk"] == 3
    assert kernel.launches["cam_search_topk_few"] == 3
    obs.reset()
