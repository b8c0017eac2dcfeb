"""The port's roofline report against the reference's, on the same records.

The dry-run writes a few small cells (smoke configs on a 2 x 2 mesh: ok
records of every kind, a skipped and an error record) into a temporary
directory; ``repro_torch.roofline.report.table`` and the reference's
``repro.roofline.report.table``, both pointed at it, must give the same
text, and ``main`` the same output.
"""

import contextlib
import io

import pytest
import torch

from repro.roofline import report as ref_report
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import report

torch.set_num_threads(2)

MESH = ((2, 2), ("data", "model"))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "RESULTS_DIR", path)
        for arch in ("granite_moe_1b_a400m", "yi_6b", "xlstm_125m"):
            cfg = get_config(arch, smoke=True)
            for shape in (ShapeCfg("train_4k", 64, 4, "train"),
                          ShapeCfg("prefill_32k", 128, 4, "prefill"),
                          ShapeCfg("decode_32k", 128, 4, "decode")):
                assert dryrun.run_cell(arch, shape, False, cfg=cfg,
                                       mesh=MESH)["status"] == "ok"
        cfg = get_config("yi_6b", smoke=True)
        dryrun.run_cell("yi_6b", ShapeCfg("long_500k", 128, 1, "decode"),
                        False, cfg=cfg, mesh=MESH)
        # d_model 64 does not split over a data axis of 3
        bad = dryrun.run_cell("yi_6b", ShapeCfg("train_4k", 64, 3, "train"),
                              False, cfg=cfg,
                              mesh=((3, 2), ("data", "model")))
        assert bad["status"] == "error"
    return path


def _both(records, monkeypatch):
    monkeypatch.setattr(report, "RESULTS", records)
    monkeypatch.setattr(ref_report, "RESULTS", records)


@pytest.mark.parametrize("mesh", ["mesh2x2", "mesh3x2"])
def test_table_equals_reference(records, monkeypatch, mesh):
    _both(records, monkeypatch)
    got = report.table(mesh)
    assert got == ref_report.table(mesh)
    assert len(got.splitlines()) == 2 + (10 if mesh == "mesh2x2" else 1)
    if mesh == "mesh2x2":
        assert "skip: quadratic attn @524k" in got and "**memory**" in got
    else:
        assert "ShardingError" in got


def test_load_and_fmt_bytes_equal_reference(records, monkeypatch):
    _both(records, monkeypatch)
    assert report.load("mesh2x2") == ref_report.load("mesh2x2")
    for b in (0, 1023, 1024, 5.5e6, 3e9, 7e12, 2e16, -4096):
        assert report.fmt_bytes(b) == ref_report.fmt_bytes(b)


def test_main_prints_both_meshes(records, monkeypatch):
    """With no records for the production meshes, both print their
    headers and empty tables alike."""
    _both(records, monkeypatch)
    outs = []
    for fn in (lambda: report.main([]), ref_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "### Mesh pod16x16" in outs[0] and "### Mesh pod2x16x16" in outs[0]


def ref_main():
    import sys
    argv, sys.argv = sys.argv, ["report"]
    try:
        ref_report.main()
    finally:
        sys.argv = argv
