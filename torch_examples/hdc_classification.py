"""End-to-end quantized HDC classification on the Table III dataset stand-ins
(paper Sec. IV-B / Fig. 10 pipeline).

Port of ``examples/hdc_classification.py``.  Encode -> single-pass train ->
iterative retrain (Eq. 4) -> Z-score quantize -> store class hypervectors
in the SEE-MCAM -> exact-match inference, compared against the
full-precision and quantized cosine baselines; then the test set encoded
and quantized in one pass by the fused ``hdc_encode`` kernel and searched
on the CAM kernels.  The projection is the port's own draw, so the
accuracies are not the reference's digits.

  PYTHONPATH=src python torch_examples/hdc_classification.py [isolet|ucihar|pamap]
  PYTHONPATH=src python torch_examples/hdc_classification.py ucihar --device cpu
"""

import argparse

import torch

from repro_torch.core import am, hdc
from repro_torch.data import hdc_data
from repro_torch.device import resolve_device
from repro_torch.kernels.hdc_encode import ops as enc_ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", default="ucihar",
                    choices=sorted(hdc_data.TABLE_III))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = hdc_data.TABLE_III[args.dataset]
    x_tr, y_tr, x_te, y_te = hdc_data.make_dataset(spec)
    print(f"dataset={spec.name}: n={spec.n_features} K={spec.n_classes} "
          f"train={len(y_tr)} test={len(y_te)} (synthetic stand-in)")

    cfg = hdc.HDCConfig(n_features=spec.n_features, n_classes=spec.n_classes,
                        dim=1024, retrain_epochs=3, bits=3)
    model = hdc.fit(hdc.make_model(cfg, device=dev), x_tr, y_tr)
    hv_te = hdc.encode(model.projection, x_te)
    y = torch.as_tensor(y_te, device=dev)

    acc_fp = hdc.accuracy(hdc.predict_cosine(model.class_hvs, hv_te), y)
    acc_q3 = hdc.accuracy(
        hdc.predict_cosine_quantized(model.class_hvs, hv_te, 3), y)
    acc_cam = hdc.accuracy(hdc.predict_cam(model, hv_te), y)
    acc_cam_k = hdc.accuracy(hdc.predict_cam(model, hv_te, backend="cuda"),
                             y)

    print(f"full-precision cosine : {acc_fp:.4f}")
    print(f"3-bit cosine (GPU ref): {acc_q3:.4f}")
    print(f"3-bit SEE-MCAM (ref)  : {acc_cam:.4f}  "
          f"(delta vs cosine {acc_cam - acc_q3:+.4f})")
    print(f"3-bit SEE-MCAM (CUDA) : {acc_cam_k:.4f}")
    assert acc_cam == acc_cam_k, "kernel must agree with oracle"

    # the fused encode + quantize kernel: per-row Z-score levels in one pass
    codes = enc_ops.encode_quantize(torch.as_tensor(x_te, device=dev),
                                    model.projection, 3)
    acc_enc = hdc.accuracy(am.search(hdc.class_table(model), codes,
                                     backend="cuda").best_row, y)
    print(f"3-bit SEE-MCAM on hdc_encode codes: {acc_enc:.4f}")

    # top-k retrieval view: how often the true class is among the k nearest
    # stored codes (the nearest-neighbor workload of the scaled search API)
    res = hdc.predict_cam_topk(model, hv_te, k=min(3, spec.n_classes))
    in_topk = (res.indices == y[:, None]).any(dim=-1)
    print(f"true class in top-{res.indices.shape[-1]} : "
          f"{float(in_topk.float().mean()):.4f}")
    assert float(in_topk.float().mean()) >= acc_cam


if __name__ == "__main__":
    main()
