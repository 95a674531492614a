"""gemma2-2b [dense]: 26L, d_model=2304, 8H (GQA kv=4), d_ff=9216,
vocab=256000; local(4096)+global alternating, attn softcap 50, final logit
softcap 30, geglu, tied + scaled embeddings.  [arXiv:2408.00118; hf]

long_500k note: the local layers hold a 4096-token ring cache; the alternate
global layers hold the full 500k KV -- linear per decode step, so the arch is
treated as sub-quadratic-capable and the global-KV memory term is called out
in the roofline table.
"""

from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab_size=256000,
    attn=AttentionConfig(n_heads=8, n_kv_heads=4, head_dim=256, window=4096,
                         attn_softcap=50.0),
    pattern=("attn_local", "attn"),
    mlp_act="geglu",
    logit_softcap=30.0,
    tie_embeddings=True,
    scale_embed=True,
    subquadratic=True,  # local/global hybrid; see module docstring
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=4,
    d_model=64,
    d_ff=256,
    vocab_size=512,
    attn=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16, window=32,
                         attn_softcap=50.0),
    max_seq_len=128,
    param_dtype="float32",
)
