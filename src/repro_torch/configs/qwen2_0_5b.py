"""qwen2-0.5b [dense]: 24L, d_model=896, 14H (GQA kv=2), d_ff=4864,
vocab=151936; GQA with QKV bias; tied embeddings.  [arXiv:2407.10671; hf]
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    attn=AttentionConfig(n_heads=14, n_kv_heads=2, head_dim=64,
                         rope_theta=1e6, qkv_bias=True),
    pattern=("attn",),
    tie_embeddings=True,
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=3,
    d_model=64,
    d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True),
    max_seq_len=128,
    param_dtype="float32",
)
