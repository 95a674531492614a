"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H, d_ff=2048,
vocab=51865.  Encoder-decoder; conv audio frontend is a stub (input_specs
provide precomputed frame embeddings).  [arXiv:2212.04356; unverified]
"""

from repro_torch.models.config import (AttentionConfig, AudioFrontendStub,
                                 EncoderConfig, ModelConfig)

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    d_ff=2048,
    vocab_size=51865,
    attn=AttentionConfig(n_heads=8, n_kv_heads=8, head_dim=64, rope=False),
    encoder=EncoderConfig(n_layers=6, n_frames=1500, d_model=512, n_heads=8,
                          d_ff=2048),
    audio=AudioFrontendStub(n_frames=1500),
    pattern=("attn",),
    mlp_act="gelu",
    norm="layernorm",
    max_seq_len=32768 + 8,
)

REDUCED = CONFIG.replace(
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=256,
    attn=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16, rope=False),
    encoder=EncoderConfig(n_layers=2, n_frames=16, d_model=64, n_heads=4,
                          d_ff=128),
    audio=AudioFrontendStub(n_frames=16),
    max_seq_len=128,
)
