"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE 32 experts top-8,
d_ff_expert=512.  Layout: TP heads (16 % 16 == 0, KV repeated x2) + EP.
"""

from repro_torch.configs.base import MoECfg, ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    moe=MoECfg(n_experts=32, top_k=8, d_ff_expert=512),
    parallel=ParallelCfg(layout="tp", ep=True),
)

SMOKE = ModelCfg(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=128,
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=64),
    parallel=ParallelCfg(layout="tp", ep=True),
)
