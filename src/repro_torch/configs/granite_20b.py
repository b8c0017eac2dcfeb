"""granite-20b (code) [arXiv:2405.04324].

52L d_model=6144 48H MQA (kv=1) d_ff=24576 vocab=49152, llama-arch.
Layout: CP (MQA -> KV all-gather is nearly free; 48 heads stay unsharded,
seq/context parallel over `model`).
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    parallel=ParallelCfg(layout="cp"),
)

SMOKE = ModelCfg(
    name="granite-20b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    parallel=ParallelCfg(layout="cp"),
)
