"""minitron-4b (pruned nemotron) [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
Layout: CP (24 heads not divisible by 16-way TP).
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    parallel=ParallelCfg(layout="cp"),
)

SMOKE = ModelCfg(
    name="minitron-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    head_dim=8,
    d_ff=96,
    vocab_size=128,
    parallel=ParallelCfg(layout="cp"),
)
