"""paligemma-3b [vlm]: 18L gemma backbone, d_model=2048, 8H (GQA kv=1),
d_ff=16384, vocab=257216; SigLIP vision tower is a stub (input_specs provide
precomputed patch embeddings, prefix-LM attention over the prefix).
[arXiv:2407.07726; hf]
"""

from repro_torch.models.config import (AttentionConfig, ModelConfig,
                                 PrefixVisionStub)

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257216,
    attn=AttentionConfig(n_heads=8, n_kv_heads=1, head_dim=256),
    vision=PrefixVisionStub(n_patches=256),
    pattern=("attn",),
    mlp_act="geglu",
    tie_embeddings=True,
    scale_embed=True,
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=3,
    d_model=64,
    d_ff=192,
    vocab_size=512,
    attn=AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=16),
    vision=PrefixVisionStub(n_patches=4),
    max_seq_len=128,
    param_dtype="float32",
)
