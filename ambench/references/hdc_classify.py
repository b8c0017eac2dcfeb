"""Plain reference of the HDC classifier's top-k lookups.

Independent of the program, a copy of ``src/repro_torch/core/hdc_plain.py``
computed in blocks on the device: each feature row goes through the
projection in full float32 (TF32 off for matrix products, cuDNN's too),
each symbol is the count of the Gaussian thresholds its product exceeds
once scaled by the row norm, ``code = #{t : (x @ P) > t * ||x||}`` with
``||x|| = sqrt(sum x^2 + 1e-12)``, and the classes are ranked by the
integer L1 distance of their codes, ascending (distance, class id).  It
imports nothing of the program and reads nothing the program made.

``check`` compares each sampled answer's class ids and distances with it.
The program's product is float32-accurate but not float32 (3xTF32 on the
tensor cores), so a symbol whose product lies within :data:`AMBIGUOUS` of a
threshold may take either code.  An answer that differs is mismatched
unless a choice of codes on its ambiguous symbols gives it exactly.

``bits`` below the configuration's gives the harness's control: the answers
one precision step below the configuration's.  The codes' bits are the
cell's shape (the class rows hold 3-bit symbols); what the configuration
states of its precision is the float32 product, and the nearest step below
it is a single TF32 product, each operand rounded to TF32's 10 fraction
bits (:func:`tf32`) and the parts multiplied and summed in float32.  Those
answers fail the check: their code changes lie mostly beyond the margin.
"""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from ambench.frozen import hdc_standin

#: Queries of one block of the product and the distances.
QUERY_BLOCK = 1024

#: A symbol is ambiguous where ``|x.P - t ||x||| <= AMBIGUOUS * scale``,
#: ``scale = sum_i |x_i| |P_i| + |t| ||x||``: the size of the terms whose
#: rounding moves the product and the threshold.  The program's 3xTF32
#: product rounds each operand to a high and a low 11-bit part and drops
#: lo.lo, at most 3 x 2^-22 = 7.2e-7 of each term, and it sums the n terms
#: in another order than float32 does (in groups on the tensor cores), some
#: 2^-24 of a partial sum each.  2e-6 takes the first whole and leaves the
#: second more than ten times its typical size.  A single TF32 product
#: errs by up to 2^-11 of each term, and most of its code changes lie
#: beyond this margin: it fails the check.
AMBIGUOUS = 2e-6

#: Most ambiguous symbols whose code choices a query's check tries (2^12
#: choices); a query with more counts as mismatched if it differs.
MAX_AMBIGUOUS = 12


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32's 10 fraction bits, to nearest with
    ties away from zero (half of the 13 dropped bits added to the bit
    pattern, then cleared), held in float32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _float32():
    """Matrix products in full float32 inside: TF32 off, cuDNN's too."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def codes(x: torch.Tensor, proj: torch.Tensor, *, single_tf32=False):
    """Level codes of the features ``x`` (B, n) through ``proj`` (n, D),
    and for each symbol how far its product lies from its nearest
    threshold and the code across that threshold.

    Returns ``(code, margin, other)``, each (B, D): ``margin`` is
    ``|x.P - t ||x||| / scale`` at the nearest threshold ``t``, with
    ``scale = sum_i |x_i| |P_i| + |t| ||x||`` (a symbol is ambiguous where
    it is at most :data:`AMBIGUOUS`), and ``other`` is one level down if
    that threshold is below the product, else one up.  ``single_tf32``
    takes the product of the operands rounded to TF32 (the control).
    """
    thr = torch.tensor(hdc_standin.THRESHOLDS_3BIT, device=x.device)
    with _float32():
        h = tf32(x) @ tf32(proj) if single_tf32 else x @ proj
        scale = x.abs() @ proj.abs()
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
    level = thr[:, None, None] * norm[None]                     # (T, B, 1)
    code = (h[None] > level).sum(dim=0)
    gap = (h[None] - level).abs()                               # (T, B, D)
    nearest = gap.argmin(dim=0)
    margin = gap.gather(0, nearest[None])[0] / (
        scale + thr.abs()[nearest] * norm)
    other = torch.where(nearest < code, code - 1, code + 1)
    return code, margin, other


def _l1(codes: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """(B, D) and (K, D) codes -> (B, K) int64 L1 distances."""
    return torch.stack([(codes - c).abs().sum(dim=1) for c in classes], 1)


def _topk(d: torch.Tensor, k: int):
    """(ids, distances) of the k smallest of each row, by (distance, id)."""
    n = d.shape[1]
    key = d * n + torch.arange(n, device=d.device)
    key = torch.topk(key, min(k, n), dim=1, largest=False).values
    return key % n, key // n


def expected(stored, words, config: dict, k: int, device,
             bits: int | None = None) -> dict:
    """The reference's answers to the feature rows ``words`` against the
    classifier ``stored`` (its ``codes`` and ``projection``).

    Returns ``indices`` and ``distances`` (Q, k), ``class_distances``
    (Q, K) and ``moves``: for each query, a (A, K) int64 array of how much
    flipping each of its A ambiguous symbols moves its distance to each
    class (empty for the control, ``bits`` below the configuration's).
    """
    full = config["table"]["bits"]
    if full != 3:
        raise ValueError("the stand-in's quantizer has 3 bits")
    control = bits is not None and bits < full
    dev = torch.device(device)
    classes = torch.as_tensor(stored.codes, device=dev).long()
    proj = torch.as_tensor(stored.projection, device=dev).float()
    x_all = torch.as_tensor(words, device=dev).float()
    idx, dist, class_d, moves = [], [], [], []
    for s in range(0, x_all.shape[0], QUERY_BLOCK):
        code, margin, other = codes(x_all[s:s + QUERY_BLOCK], proj,
                                    single_tf32=control)
        d = _l1(code, classes)
        i, v = _topk(d, k)
        idx.append(i.cpu())
        dist.append(v.cpu())
        class_d.append(d.cpu())
        moves += _moves(code, margin <= AMBIGUOUS, other, classes, control)
    return {"indices": torch.cat(idx).numpy(),
            "distances": torch.cat(dist).numpy().astype(np.float64),
            "class_distances": torch.cat(class_d).numpy(), "moves": moves}


def _moves(code, amb, other, classes, control: bool) -> list:
    """For each query of a block, (A, K) int64: how much taking the other
    code of each of its A ambiguous symbols moves its distance to each
    class (none for the control)."""
    empty = np.zeros((0, classes.shape[0]), np.int64)
    if control:
        return [empty] * code.shape[0]
    q, j = amb.nonzero(as_tuple=True)
    c = classes[:, j].T                                         # (M, K)
    m = ((other[q, j, None] - c).abs() - (code[q, j, None] - c).abs())
    per = torch.bincount(q, minlength=code.shape[0]).tolist()
    return [t.numpy() for t in torch.split(m.cpu(), per)]


def _explained(ids, dists, class_d: np.ndarray, moves: np.ndarray) -> bool:
    """Whether some choice of codes on the ambiguous symbols gives the
    answer (ids, dists) exactly."""
    a, n = moves.shape
    if a == 0 or a > MAX_AMBIGUOUS:
        return False
    picks = np.array(list(itertools.product((0, 1), repeat=a)), np.int64)
    d = class_d[None] + picks @ moves                           # (2^a, K)
    key = np.sort(d * n + np.arange(n), axis=1)[:, :len(ids)]
    return bool(np.any(np.all(key % n == ids, axis=1)
                       & np.all(key // n == dists, axis=1)))


def mismatched(answers: list, want: dict) -> int:
    """How many answers differ from the reference in their class ids or
    distances, where no choice of codes on the query's ambiguous symbols
    explains the difference."""
    bad = 0
    for i, a in enumerate(answers):
        idx, dist = want["indices"][i], want["distances"][i]
        if a is None:
            bad += 1
            continue
        ids = np.asarray(a.indices, np.int64)
        dists = np.asarray(a.distances, np.float64)
        if np.array_equal(ids, idx) and np.array_equal(dists, dist):
            continue
        bad += not _explained(ids, dists, want["class_distances"][i],
                              want["moves"][i])
    return bad


def check(inputs, config: dict, mix: dict, items: list, device,
          bits: int | None = None) -> dict:
    """Hold the sampled (key, answer) pairs of a run to the reference.

    Returns ``mismatched`` (answers that differ, a missing one included)
    and ``facts`` for the metric readers (none).
    """
    if not items:
        return {"mismatched": 0, "facts": {}}
    keys = torch.as_tensor(np.array([k for k, _ in items], np.int64))
    want = expected(inputs.stored, inputs.words[keys.to(inputs.words.device)],
                    config, mix["k"], device, bits)
    return {"mismatched": mismatched([a for _, a in items], want),
            "facts": {}}


class Answer:
    """An answer made from reference arrays."""

    def __init__(self, indices, distances):
        self.indices = np.asarray(indices, np.int64)
        self.distances = np.asarray(distances, np.float64)


def answers(want: dict) -> list:
    """The reference's arrays as one :class:`Answer` per query."""
    return [Answer(i, d) for i, d in zip(want["indices"], want["distances"])]
