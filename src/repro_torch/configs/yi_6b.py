"""yi-6b [arXiv:2403.04652].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, llama-arch GQA.
Layout: TP heads (32 % 16 == 0; KV repeated x4 to the TP width).
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab_size=64_000,
    parallel=ParallelCfg(layout="tp"),
)

SMOKE = ModelCfg(
    name="yi-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=128,
    parallel=ParallelCfg(layout="tp"),
)
