"""internlm2-20b [arXiv:2403.17297].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
Layout: TP heads (48 % 16 == 0; KV repeated x2).
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_544,
    parallel=ParallelCfg(layout="tp"),
)

SMOKE = ModelCfg(
    name="internlm2-20b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=4,
    head_dim=8,
    d_ff=128,
    vocab_size=128,
    parallel=ParallelCfg(layout="tp"),
)
