"""deepseek-67b [dense]: 95L, d_model=8192, 64H (GQA kv=8), d_ff=22016,
vocab=102400; llama-arch.  [arXiv:2401.02954; hf]
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    d_ff=22016,
    vocab_size=102400,
    attn=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128),
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
