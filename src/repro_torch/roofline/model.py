"""Three-term roofline model of one NVIDIA H100 SXM.

Port of :mod:`repro.roofline.model`, whose constants are a TPU v5e's:

    compute term    = per-device FLOPs / peak FLOP/s
    memory term     = per-device bytes moved / HBM bandwidth
    collective term = per-device bytes on NVLink / NVLink bandwidth
                      + per-device bytes on the network / NIC bandwidth

The reference reads its FLOPs and bytes from XLA's ``cost_analysis()`` of
a compiled program and its collective bytes from the HLO text.  PyTorch
has no such compiled program, so here every count comes from the caller:
FLOPs and bytes computed from the shapes the torch code runs at (each
input read once, each output written once), and the collective bytes of
the collectives it issues.

``count_params``, ``active_params`` and ``model_flops`` are the
reference's arithmetic, unchanged: MODEL_FLOPS = 6 * N * D for training
(N the parameters a token touches, D the tokens), 2 * N * D for a forward.
The count leaves out norm scales and biases other than the RG-LRU's, and
takes the unpadded vocabulary.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the full
# 700 W power limit.
PEAK_FLOPS_BF16 = 989e12      # tensor cores, bf16 and fp16
PEAK_FLOPS_TF32 = 495e12      # tensor cores, TF32
PEAK_FLOPS_FP32 = 67e12       # CUDA cores, float32
PEAK_OPS_INT8 = 1.979e15      # tensor cores, int8
HBM_BW = 3.35e12              # HBM3 bytes/s
# NVLink 4 (H100 SXM5 data sheet: 900 GB/s per GPU, both directions
# together): 18 links of 25 GB/s each way.
NVLINK_BW_PER_LINK = 25e9     # bytes/s per link, one direction
NVLINK_LINKS = 18
# Between hosts: one 400 Gb/s NIC per GPU (NVIDIA DGX H100 data sheet:
# eight ConnectX-7 400 Gb/s ports for eight GPUs), 50 GB/s each way.
NET_BW = 50e9                 # bytes/s per GPU, one direction


@dataclasses.dataclass
class Roofline:
    """The three terms of one program on ``n_chips`` H100s; every count
    is the caller's (module docstring).  ``coll_bytes_nvlink`` and
    ``coll_bytes_net`` take the reference's ``coll_bytes_ici`` and
    ``coll_bytes_dcn`` places: within a host, and across hosts."""

    flops: float                # per-device FLOPs
    hbm_bytes: float            # per-device bytes moved
    coll_bytes_nvlink: float    # per-device collective bytes (in the host)
    coll_bytes_net: float       # per-device collective bytes (across hosts)
    model_flops_global: float   # 6*N*D useful flops (global)
    n_chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.coll_bytes_nvlink / (NVLINK_BW_PER_LINK * NVLINK_LINKS)
                + self.coll_bytes_net / NET_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline time: the engines overlap, so the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS over the FLOPs run on all chips (recompute and
        redundancy make it less than 1)."""
        total = self.flops * self.n_chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU: useful flops / (chips * peak * t_bound)."""
        denom = self.n_chips * PEAK_FLOPS_BF16 * self.t_bound
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_nvlink": self.coll_bytes_nvlink,
            "coll_bytes_net": self.coll_bytes_net,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "model_flops_global": self.model_flops_global,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu_bound,
            "n_chips": self.n_chips,
        }


def bound_ms(bytes_moved: float, ops: float, peak_ops: float
             ) -> tuple[float, float]:
    """(ms at the HBM rate, ms at ``peak_ops``) for one call's work."""
    return bytes_moved / HBM_BW * 1e3, ops / peak_ops * 1e3


def count_params(cfg) -> int:
    """Analytic parameter count (total) for MODEL_FLOPS."""
    d, l, v = cfg.d_model, cfg.n_layers, cfg.vocab_size
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    total = v * d                                   # embeddings (tied head)
    for i in range(l):
        kind = cfg.block_kind(i)
        if kind in ("attn", "local"):
            if cfg.mla is not None:
                m = cfg.mla
                total += d * h * (m.nope_head_dim + m.rope_head_dim)
                total += d * (m.kv_lora_rank + m.rope_head_dim)
                total += m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
                total += h * m.v_head_dim * d
            else:
                total += d * (h + 2 * hk) * dh + h * dh * d
            if cfg.moe is not None:
                total += d * cfg.moe.n_experts      # router
                total += cfg.moe.n_experts * 3 * d * cfg.moe.d_ff_expert
                total += cfg.moe.n_shared * 3 * d * cfg.moe.d_ff_expert
            else:
                total += 3 * d * cfg.d_ff
        elif kind == "rglru":
            r = d
            total += 2 * d * r + 2 * r * r + r * d + 4 * r
            total += 3 * d * cfg.d_ff
        elif kind == "mlstm":
            up = 2 * d
            total += 2 * d * up + 3 * up * h * dh + up * 2 * h + up * d
        elif kind == "slstm":
            total += 4 * d * d + d * d
    return total


def active_params(cfg) -> int:
    """Params touched per token (MoE: only routed top-k + shared)."""
    if cfg.moe is None:
        return count_params(cfg)
    m = cfg.moe
    full = count_params(cfg)
    all_experts = cfg.n_layers * m.n_experts * 3 * cfg.d_model * m.d_ff_expert
    # shared experts were counted separately already; subtract routed-only
    return full - all_experts + cfg.n_layers * m.top_k * 3 * cfg.d_model \
        * m.d_ff_expert


def model_flops(cfg, shape, kind: str) -> float:
    """6*N_active*D for training; 2*N_active*D for inference steps."""
    n = active_params(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
