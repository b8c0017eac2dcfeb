"""recurrentgemma-2b (Griffin) [arXiv:2402.19427].

26L d_model=2560 10H MQA (kv=1) head_dim=256 d_ff=7680 vocab=256000.
Block pattern: (RG-LRU, RG-LRU, local-attn window 2048) repeating — the
Griffin 2:1 residual-block mix (the pool line's "1:2" = 1 attention per
2 recurrent blocks).  Sub-quadratic -> runs long_500k.
Layout: CP (10 heads not divisible; local attention + linear recurrence).
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    scan_layers=False,
    parallel=ParallelCfg(layout="cp"),
)

SMOKE = ModelCfg(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=128,
    block_pattern=("rglru", "rglru", "local"),
    local_window=16,
    scan_layers=False,
    parallel=ParallelCfg(layout="cp"),
)
