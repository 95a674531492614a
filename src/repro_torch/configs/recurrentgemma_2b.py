"""recurrentgemma-2b [hybrid]: 26L, d_model=2560, 10H (GQA kv=1), d_ff=7680,
vocab=256000; RG-LRU + local attention in a (rec, rec, attn_local) 1:2
pattern, window 2048.  [arXiv:2402.19427; hf]
"""

from repro_torch.models.config import AttentionConfig, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    d_ff=7680,
    vocab_size=256000,
    attn=AttentionConfig(n_heads=10, n_kv_heads=1, head_dim=256, window=2048),
    rglru=RGLRUConfig(width=2560, conv_width=4),
    pattern=("rec", "rec", "attn_local"),
    mlp_act="geglu",
    tie_embeddings=True,
    scale_embed=True,
    subquadratic=True,
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=3,
    d_model=64,
    d_ff=192,
    vocab_size=512,
    attn=AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=16, window=32),
    rglru=RGLRUConfig(width=64, conv_width=4),
    max_seq_len=128,
    param_dtype="float32",
)
