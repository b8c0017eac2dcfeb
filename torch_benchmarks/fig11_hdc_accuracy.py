"""Fig. 11: quantized HDC classification accuracy.

Port of ``benchmarks/fig11_hdc_accuracy.py``:

(a) binary cosine (COSIME proxy) vs 3-bit cosine vs binary SEE-MCAM vs 3-bit
    SEE-MCAM at D=1024, on the three Table III dataset stand-ins.
(b) SEE-MCAM density scaling: the same cell budget stores D=1024 (1b/cell
    baseline budget) vs D=2048 (2b) vs D=4096 (3b) dimensions.

The CAM inference runs ``am.search`` on the ``"cuda"`` backend (the fused
CAM kernel on the GPU; bitwise the reference's default ``"ref"``
backend).  The port draws its own projection (``hdc.make_model``), so its
accuracies are the same study on another random projection, not the
reference's digits.  One row per dataset is added: the test set encoded
and quantized by the fused ``hdc_encode`` kernel (``encode_quantize``, 3
bits, D = 1,024), timed, and the CAM accuracy on those codes.

``--smoke`` runs only the ucihar stand-in, cut to 1,500 / 500 rows as
``tests/test_system.py`` cuts it (the full study is minutes on a CPU).

  PYTHONPATH=src python torch_benchmarks/fig11_hdc_accuracy.py [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from torch_benchmarks.common import emit, time_call  # noqa: E402
from repro_torch.core import am, hdc  # noqa: E402
from repro_torch.data import hdc_data  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.hdc_encode import ops as enc_ops  # noqa: E402


def _fit(spec, data, dim, bits, dev, seed=0):
    x_tr, y_tr, _, _ = data
    cfg = hdc.HDCConfig(n_features=spec.n_features, n_classes=spec.n_classes,
                        dim=dim, retrain_epochs=3, bits=bits, seed=seed)
    return hdc.fit(hdc.make_model(cfg, device=dev), x_tr, y_tr)


def _fit_eval(spec, data, dim, bits, mode, dev, seed=0):
    _, _, x_te, y_te = data
    model = _fit(spec, data, dim, bits, dev, seed)
    hv = hdc.encode(model.projection, x_te)
    if mode == "cos":
        pred = hdc.predict_cosine_quantized(model.class_hvs, hv, bits)
    else:
        # the library's shipped CAM inference path (AMTable + am.search)
        pred = hdc.predict_cam(model, hv, backend="cuda")
    return hdc.accuracy(pred, y_te)


def _specs(smoke):
    if smoke:
        spec = dataclasses.replace(hdc_data.TABLE_III["ucihar"],
                                   train_size=1500, test_size=500)
        return {"ucihar": spec}
    return hdc_data.TABLE_III


def run(smoke: bool = False, device=None):
    dev = resolve_device(device)
    specs = _specs(smoke)
    data = {name: hdc_data.make_dataset(spec) for name, spec in specs.items()}
    for name, spec in specs.items():
        accs = {}
        for label, (bits, mode) in {
            "cos_1b": (1, "cos"), "cos_3b": (3, "cos"),
            "cam_1b": (1, "cam"), "cam_3b": (3, "cam"),
        }.items():
            accs[label] = _fit_eval(spec, data[name], 1024, bits, mode, dev)
        emit(f"fig11a_{name}", 0.0,
             ";".join(f"{k}={v:.4f}" for k, v in accs.items())
             + f";cam3b_minus_cos3b={accs['cam_3b'] - accs['cos_3b']:+.4f}"
             + f";cam1b_minus_cos1b={accs['cam_1b'] - accs['cos_1b']:+.4f}")

    # (b) equal-cell-budget density scaling (1024 cells): 1b/2b/3b cells
    for name, spec in specs.items():
        a1 = _fit_eval(spec, data[name], 1024, 1, "cam", dev)
        a2 = _fit_eval(spec, data[name], 2048, 2, "cam", dev)
        a3 = _fit_eval(spec, data[name], 4096, 3, "cam", dev)
        emit(f"fig11b_{name}", 0.0,
             f"d1024_1b={a1:.4f};d2048_2b={a2:.4f};d4096_3b={a3:.4f};"
             f"density_gain={a3 - a1:+.4f}")

    # the fused encode + quantize kernel on each test set, and the CAM
    # inference on its codes (per-row Z-score levels, H | x ~ N(0, |x|^2))
    for name, spec in specs.items():
        _, _, x_te, y_te = data[name]
        model = _fit(spec, data[name], 1024, 3, dev)
        x = torch.as_tensor(x_te, device=dev)
        us = time_call(lambda: enc_ops.encode_quantize(x, model.projection,
                                                       3))
        codes = enc_ops.encode_quantize(x, model.projection, 3)
        pred = am.search(hdc.class_table(model), codes,
                         backend="cuda").best_row
        emit(f"fig11_encode_{name}", us,
             f"rows={x.shape[0]};rows_per_s={x.shape[0] / (us * 1e-6):.0f};"
             f"cam_3b_on_kernel_codes={hdc.accuracy(pred, y_te):.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the ucihar stand-in only, cut to 1,500 / 500 rows")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
