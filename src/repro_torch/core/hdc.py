"""Quantized Hyperdimensional Computing (HDC) pipeline (paper Sec. IV-B, Fig. 10).

Port of :mod:`repro.core.hdc`.  Stages:
  encode    : F in R^n --(n x D i.i.d. Gaussian projection)--> H in R^D
  train     : single-pass class-hypervector aggregation  C_l = sum_k H_l
  retrain   : iterative perceptron-style update (Eq. 4), eta = 0.03
  quantize  : Z-score CDF-equalized quantization of queries + class vectors
  inference : - full-precision / quantized cosine similarity (GPU baseline), or
              - SEE-MCAM multi-bit exact-match associative search: the class
                whose stored code has the FEWEST mismatching cells wins (the
                analog ML-discharge ranking), via :mod:`repro_torch.core.am`.

A model's tensors live on one device (the GPU unless ``device="cpu"``);
host arrays passed to these functions go to the model's device.  The
functions never update a model's tensors in place.  On the GPU the class
hypervectors are scatter-added with atomics, so their last bits vary from
run to run; on the CPU they are deterministic.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quantize as q
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HDCConfig:
    n_features: int
    n_classes: int
    dim: int = 1024          # hyperdimensionality D
    lr: float = 0.03         # eta in Eq. (4)
    retrain_epochs: int = 5
    bits: int = 3            # cell precision for the quantized/CAM model
    seed: int = 0


@dataclasses.dataclass
class HDCModel:
    config: HDCConfig
    projection: torch.Tensor   # (n, D) float32, i.i.d. N(0,1)
    class_hvs: torch.Tensor    # (K, D) float32 full-precision class hypervectors

    @property
    def device(self) -> torch.device:
        return self.projection.device

    # -- quantized views ----------------------------------------------------
    def quantized_class_codes(self) -> torch.Tensor:
        """(K, D) int32 level codes of the class hypervectors (global Z)."""
        return q.quantize(self.class_hvs, self.config.bits, axis=None)

    def quantize_queries(self, hvs) -> torch.Tensor:
        return q.quantize(_on(hvs, self.device), self.config.bits, axis=None)


def _on(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def make_model(cfg: HDCConfig, device=None) -> HDCModel:
    """A model with an N(0, 1) projection drawn from a ``torch.Generator``
    seeded by ``cfg.seed``, and zero class hypervectors.

    The draw is made on the CPU and copied to ``device`` (default the GPU),
    so a seed gives the same projection on every device.  It is not the
    reference's draw: carry that across with
    :func:`repro_torch.convert.hdc_model_from_numpy`.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    proj = torch.randn((cfg.n_features, cfg.dim), generator=gen,
                       dtype=torch.float32)
    return HDCModel(cfg, proj.to(dev),
                    torch.zeros((cfg.n_classes, cfg.dim), dtype=torch.float32,
                                device=dev))


# -- prompt cache keys (serving) --------------------------------------------
#
# The CAM-fronted response cache keys prompts by a bag-of-tokens HDC code:
# token ids index a fixed Gaussian projection, the hypervectors sum, and the
# result Z-quantizes to CAM levels.

def token_key_projection(vocab: int, dim: int, seed: int = 9,
                         device=None) -> torch.Tensor:
    """(vocab, dim) i.i.d. N(0, 1) projection for prompt cache keys.

    Drawn on the CPU from a generator seeded by ``seed``, then copied to
    ``device`` (default the GPU).
    """
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((vocab, dim), generator=gen,
                       dtype=torch.float32).to(resolve_device(device))


def prompt_key(projection: torch.Tensor, tokens, bits: int = 3) -> torch.Tensor:
    """Bag-of-tokens HDC cache key of a token-id sequence, as level codes."""
    idx = torch.as_tensor(tokens, device=projection.device).long()
    return q.quantize(projection[idx].sum(dim=0), bits)


def encode(projection: torch.Tensor, x) -> torch.Tensor:
    """Random-projection encoding F -> H (batch, D): one float32 product."""
    return _on(x, projection.device) @ projection


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-9)
    b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-9)
    return a @ b.T


def train_single_pass(class_hvs: torch.Tensor, hvs: torch.Tensor,
                      labels) -> torch.Tensor:
    """C_l = sum of encoded hypervectors per class (one pass, Fig. 10)."""
    labels = torch.as_tensor(labels, device=class_hvs.device).long()
    return class_hvs.index_add(0, labels, hvs)


def retrain_epoch(class_hvs: torch.Tensor, hvs: torch.Tensor, labels,
                  lr: float = 0.03) -> torch.Tensor:
    """One iterative-training epoch implementing Eq. (4).

    For each mispredicted sample Q with true label l and prediction l':
        C_l  <- C_l  + eta (1 - delta) Q
        C_l' <- C_l' - eta (1 - delta) Q
    where delta is the cosine similarity to the *correct* class.  Applied in
    one vectorised batch step (order-independent approximation of the paper's
    sequential pass — standard in HDC implementations).
    """
    labels = torch.as_tensor(labels, device=class_hvs.device).long()
    sims = _cosine(hvs, class_hvs)                       # (B, K)
    pred = torch.argmax(sims, dim=-1)
    wrong = pred != labels
    delta = torch.gather(sims, 1, labels[:, None])[:, 0]
    scale = torch.where(wrong, lr * (1.0 - delta), 0.0)[:, None] * hvs
    class_hvs = class_hvs.index_add(0, labels, scale)
    return class_hvs.index_add(0, pred, -scale)


def fit(model: HDCModel, x, y) -> HDCModel:
    """Single-pass + iterative retraining on (x, y)."""
    hvs = encode(model.projection, x)
    chv = train_single_pass(model.class_hvs, hvs, y)
    for _ in range(model.config.retrain_epochs):
        chv = retrain_epoch(chv, hvs, y, model.config.lr)
    return dataclasses.replace(model, class_hvs=chv)


# ---------------------------------------------------------------------------
# Inference paths
# ---------------------------------------------------------------------------

def predict_cosine(class_hvs: torch.Tensor, hvs: torch.Tensor) -> torch.Tensor:
    """Full-precision cosine-similarity prediction (the GPU reference)."""
    return torch.argmax(_cosine(hvs, class_hvs), dim=-1).to(torch.int32)


def predict_cosine_quantized(class_hvs: torch.Tensor, hvs: torch.Tensor,
                             bits: int) -> torch.Tensor:
    """Quantized cosine baseline: both sides quantized, then cosine on the
    dequantized representatives (paper's '3-bit cosine similarity')."""
    cq = q.dequantize(q.quantize(class_hvs, bits), bits)
    hq = q.dequantize(q.quantize(hvs, bits), bits)
    return torch.argmax(_cosine(hq, cq), dim=-1).to(torch.int32)


def class_table(model: HDCModel, *, distance: str = "l1"):
    """The quantized class hypervectors as an :class:`repro_torch.core.am.AMTable`.

    This is literally "the model stored in the SEE-MCAM array": an immutable
    code table, on the model's device, over which inference is an
    associative search.
    """
    from repro_torch.core import am  # local import, as in the reference
    return am.make_table(model.quantized_class_codes(),
                         bits=model.config.bits, distance=distance,
                         device=model.device)


def predict_cam(model: HDCModel, hvs, *, backend: str = "ref",
                distance: str = "l1") -> torch.Tensor:
    """SEE-MCAM associative-search prediction.

    The class codes live in the MCAM rows; each quantized query is searched
    in parallel and the best-matching row wins.  ``distance="l1"`` is the
    analog ML-discharge ranking the paper's HDC benchmarking uses;
    ``distance="hamming"`` is strict digital symbol-mismatch counting.
    ``backend``: any name registered with ``am.register_backend`` ("ref",
    "cuda" (alias "pallas"), "analog", "analog_cal") or a raw backend
    callable.
    """
    from repro_torch.core import am
    table = class_table(model, distance=distance)
    return am.search(table, model.quantize_queries(hvs),
                     backend=backend).best_row


def predict_cam_topk(model: HDCModel, hvs, k: int, *, backend: str = "ref",
                     distance: str = "l1"):
    """Top-k class candidates per query (an :class:`am.AMSearchResult`) —
    the retrieval view of HDC inference (nearest-neighbor search over class
    codes)."""
    from repro_torch.core import am
    table = class_table(model, distance=distance)
    return am.search(table, model.quantize_queries(hvs), k=k, backend=backend)


def accuracy(pred, labels) -> float:
    pred = torch.as_tensor(pred)
    labels = torch.as_tensor(labels, device=pred.device)
    return float((pred == labels).float().mean())
