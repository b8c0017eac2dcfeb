"""musicgen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=1536 24H MHA (kv=24) d_ff=6144 vocab=2048.  The EnCodec audio
frontend is a STUB per the assignment: input_specs() provides precomputed
frame embeddings which a learned projection folds into the token stream.
Layout: CP (24 heads not divisible by 16).
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
    n_prefix_embeds=256,
    parallel=ParallelCfg(layout="cp"),
)

SMOKE = ModelCfg(
    name="musicgen-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    frontend="audio",
    n_prefix_embeds=8,
    parallel=ParallelCfg(layout="cp"),
)
