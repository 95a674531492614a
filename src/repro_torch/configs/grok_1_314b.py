"""grok-1-314b [moe]: 64L, d_model=6144, 48H (GQA kv=8), expert d_ff=32768,
vocab=131072; MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]
"""

from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab_size=131072,
    attn=AttentionConfig(n_heads=48, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    pattern=("attn",),
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=3,
    d_model=64,
    d_ff=256,
    vocab_size=512,
    attn=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
    max_seq_len=128,
    param_dtype="float32",
)
