"""The port's example and benchmarks of the TCAM and index slice, on the CPU.

Each script runs in a subprocess with ``--device cpu`` (``--smoke`` for the
benchmarks, whose gates are assertions: the all-care identity, the
multi-match and LPM oracles, ``probes == sets`` bitwise the flat search,
recall@10 >= 0.9 at P = 4 / S = 32 and the candidate-fraction bound), and
must import neither ``jax`` nor the reference package.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = (
    "import runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
    "assert not bad, bad\n")


def _run(script, *args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _RUN,
                          os.path.join(ROOT, script), *args, "--device",
                          "cpu"], env=env, capture_output=True, text=True,
                         timeout=300, cwd=cwd)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_lpm_routing_example():
    out = _run("torch_examples/lpm_routing.py")
    assert "all 55 lookups match lpm_oracle" in out


def test_bench_tcam_smoke():
    out = _run("torch_benchmarks/bench_tcam.py", "--smoke")
    assert "smoke gates passed" in out
    assert "tcam_lpm_r" in out


def test_bench_am_index_smoke(tmp_path):
    _run("torch_benchmarks/bench_am_index.py", "--smoke", cwd=tmp_path)
    report = json.loads((tmp_path / "BENCH_index.json").read_text())
    gate = report["probes"]["4"]
    assert gate["recall_at_k"] >= 0.9
    assert report["probes"]["32"]["recall_proxy"] == 1.0
    assert report["device"] == "cpu"
