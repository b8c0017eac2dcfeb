"""Model / parallelism / shape configuration dataclasses.

A copy of :mod:`repro.configs.base` (data-only dataclasses), so the port's
configs compare equal field for field with the reference's.  Every assigned
architecture gets one ``configs/<id>.py`` exporting ``CONFIG: ModelCfg``
built from these dataclasses, plus a reduced smoke config.  The port runs on
one device: of :class:`ParallelCfg` it reads ``kv_replicate`` and
``attn_impl``; the layout and sharding knobs are carried for the sharding
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int               # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLACfg:
    """DeepSeek-V2 Multi-head Latent Attention geometry."""
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    """How this arch maps onto the (pod, data, model) production mesh.

    layout:
      "tp" — Megatron head/FF tensor parallel over `model`, sequence-parallel
             residual stream, FSDP over `data`.  Requires heads % tp == 0
             (KV heads are repeated up to tp if fewer).
      "cp" — 2-D FSDP weights + context-parallel attention (seq over `model`,
             KV all-gather for train, softmax-merge sharded-KV decode).
    """
    layout: str = "tp"
    ep: bool = False             # expert parallelism over `model`
    remat: str = "block"         # "none" | "block" (remat each layer)
    # ---- beyond-paper perf knobs (EXPERIMENTS.md §Perf) -------------------
    # store K/V projection weights pre-replicated to N x kv_heads so the head
    # axis shards without runtime jnp.repeat (kills the involuntary-remat
    # reshard + its collectives in layout "tp" GQA archs)
    kv_replicate: int = 1
    # keep attention scores/probs in bf16 (f32 reductions stay small):
    # halves the dominant score-tensor HBM traffic of non-flash attention
    attn_bf16_scores: bool = False
    # MoE ZeRO-1: expert weights sharded over `model` only (no per-layer FSDP
    # all-gather); optimizer state additionally sharded over `data`, weights
    # re-gathered once per step at the optimizer boundary
    moe_zero1: bool = False
    # sequence-parallel residual stream (Megatron-SP).  False = classic
    # Megatron: residual replicated across `model`; trades the backward
    # reshard all-reduces for forward row-parallel all-reduces.
    resid_seq_shard: bool = True
    # attention implementation: "einsum" (XLA, scores materialised) or
    # "flash" (Pallas online-softmax kernel, kernels/flash_attention —
    # per-device; TPU Mosaic target, interpret-validated on CPU)
    attn_impl: str = "einsum"

    def __post_init__(self):
        if self.layout not in ("tp", "cp"):
            raise ValueError(self.layout)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer-type cycle, indexed by layer % len(pattern):
    #   "attn" | "local" | "rglru" | "mlstm" | "slstm"
    block_pattern: tuple = ("attn",)
    local_window: int = 2048
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    frontend: Optional[str] = None      # None | "audio" | "vision"
    n_prefix_embeds: int = 256          # stub frontend prefix length (vlm/audio)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scan_layers: bool = True            # scan over stacked layers when uniform
    dtype: str = "bfloat16"
    parallel: ParallelCfg = ParallelCfg()

    # ---- derived -----------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows: vocab rounded up to a multiple of 256 so the
        vocab axis divides 16-way TP and stays 128-lane aligned (standard
        padded-vocab training; labels never index the padding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def uniform_pattern(self) -> bool:
        return len(set(self.block_pattern)) == 1

    def block_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    @property
    def attends_globally(self) -> bool:
        """True if any layer is full (quadratic) self-attention."""
        return "attn" in self.block_pattern

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs run the long_500k shape (DESIGN.md §4)."""
        return not self.attends_globally

    def validate(self) -> None:
        if "attn" in self.block_pattern or "local" in self.block_pattern:
            if self.mla is None:
                assert self.n_heads % self.n_kv_heads == 0, self.name
        if self.parallel.ep:
            assert self.moe is not None, self.name


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelCfg, shape: ShapeCfg) -> bool:
    """The assignment's skip rule: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
