"""deepseek-v2-lite-16b [arXiv:2405.04434].

27L d_model=2048 16H, MLA (kv_lora_rank=512, rope 64 / nope 128 / v 128),
MoE: 64 routed experts top-6 + 2 shared, d_ff_expert=1408, vocab=102400.
(The pool line's "160 routed" belongs to the full V2; the lite/16B variant is
64 routed — see DESIGN.md §4.)  Layout: TP heads (16/16) + EP.
"""

from repro_torch.configs.base import MLACfg, MoECfg, ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    mla=MLACfg(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
               v_head_dim=128),
    parallel=ParallelCfg(layout="tp", ep=True),
)

SMOKE = ModelCfg(
    name="deepseek-v2-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=128,
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=96, n_shared=1),
    mla=MLACfg(kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
               v_head_dim=16),
    parallel=ParallelCfg(layout="tp", ep=True),
)
