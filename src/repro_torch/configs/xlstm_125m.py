"""xlstm-125m [arXiv:2405.04517].

12L d_model=768 4H head_dim=192 d_ff=0 (capacity inside the blocks)
vocab=50304.  Pattern: mLSTM with sLSTM every 4th block (the paper's mixed
sLSTM+mLSTM stacks).  Fully recurrent -> runs long_500k.
Layout: CP-family sharding (batch DP + internal width TP); heads stay local.
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    scan_layers=False,
    parallel=ParallelCfg(layout="cp"),
)

SMOKE = ModelCfg(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=128,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    scan_layers=False,
    parallel=ParallelCfg(layout="cp"),
)
