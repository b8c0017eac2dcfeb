"""pixtral-12b [hf:mistralai/Pixtral-12B-2409] — mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.  The pixtral ViT
vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings folded in as a learned-projection prefix.
Layout: TP heads (32 % 16 == 0; KV repeated x2).
"""

from repro_torch.configs.base import ModelCfg, ParallelCfg

CONFIG = ModelCfg(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    frontend="vision",
    n_prefix_embeds=256,
    parallel=ParallelCfg(layout="tp"),
)

SMOKE = ModelCfg(
    name="pixtral-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=128,
    frontend="vision",
    n_prefix_embeds=8,
    parallel=ParallelCfg(layout="tp"),
)
