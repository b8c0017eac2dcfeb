"""The port stands alone: no JAX, no reference package, no hidden fallback.

* importing the port's modules pulls in neither ``jax`` nor ``repro``;
* with no GPU, the entry points that default to the GPU raise instead of
  running on the CPU;
* a CPU tensor never reaches the CUDA kernel loader: the CPU path of every
  entry point runs the plain versions.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import am
from repro_torch.kernels import _build
from repro_torch.kernels.cam_search import kernel, ops
from repro_torch.serve import AMService

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.am, repro_torch.serve\n"
        "import repro_torch.convert, repro_torch.kernels.cam_search\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_no_gpu_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = np.zeros((4, 8), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AMService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        am.make_table(codes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        am.serving_meta(4, 0.0)
    # asking for the CPU explicitly works
    assert am.make_table(codes, device="cpu").device.type == "cpu"


def test_cpu_tensors_never_reach_the_kernel_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel loader reached for {name!r}")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    kernel.reset_launches()
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 8, (50, 12)).astype(np.int32)
    q = torch.from_numpy(codes[:4])
    t = torch.from_numpy(codes)
    ops.mismatch_counts(q, t, 3)
    ops.topk_fused(q, t, k=3, bits=3, valid_rows=40, count_le=2.0)
    table = am.make_table(codes, bits=3, distance="l1", device="cpu")
    am.search(table, codes[:4], k=3, backend="cuda")
    am.search(table, codes[:4], k=300, backend="pallas")
    am.search(table, codes[:4], matches=2, backend="cuda")
    svc = AMService(device="cpu")
    svc.create_table("t", width=12, capacity=64, backend="cuda",
                     ternary=True)
    svc.append("t", codes)
    assert svc.lookup("t", codes[5], k=2).best_row == 5
    assert kernel.launches == {"cam_search": 0, "cam_search_topk": 0}
    # and a CPU tensor handed to a kernel wrapper is refused, not loaded
    with pytest.raises(ValueError, match="CUDA"):
        kernel.cam_search(q.to(torch.int8), t.to(torch.int8), levels=8)


def test_mixed_devices_are_refused():
    q = torch.zeros((1, 4), dtype=torch.int32)
    t = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="queries on"):
        ops.mismatch_counts(q, t)
