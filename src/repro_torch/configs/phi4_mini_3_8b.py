"""phi4-mini-3.8b [dense]: 32L, d_model=3072, 24H (GQA kv=8), d_ff=8192,
vocab=200064; RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf]
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=200064,
    attn=AttentionConfig(n_heads=24, n_kv_heads=8, head_dim=128),
    pattern=("attn",),
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=3,
    d_model=96,
    d_ff=256,
    vocab_size=512,
    attn=AttentionConfig(n_heads=6, n_kv_heads=2, head_dim=16),
    max_seq_len=128,
    param_dtype="float32",
)
