"""deepseek-v3-671b [moe]: 61L, d_model=7168, 128H MLA, expert d_ff=2048,
vocab=129280; MoE 256 routed top-8 + 1 shared; first 3 layers dense
(d_ff=18432); MTP head.  [arXiv:2412.19437; hf]
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    d_ff=18432,  # dense layers (first moe_start_layer layers)
    vocab_size=129280,
    mla=MLAConfig(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
    pattern=("mla",),
    moe_start_layer=3,
    mtp=True,
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=4,
    d_model=64,
    d_ff=128,
    vocab_size=512,
    mla=MLAConfig(n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1),
    moe_start_layer=1,
    max_seq_len=128,
    param_dtype="float32",
)
