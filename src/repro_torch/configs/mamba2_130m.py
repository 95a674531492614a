"""mamba2-130m [ssm]: 24L, d_model=768, attention-free SSD blocks,
vocab=50280, ssm_state=128.  [arXiv:2405.21060; unverified]
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=256),
    pattern=("ssm",),
    tie_embeddings=True,
    subquadratic=True,
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=3,
    d_model=64,
    vocab_size=512,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4, chunk=32),
    max_seq_len=128,
    param_dtype="float32",
)
