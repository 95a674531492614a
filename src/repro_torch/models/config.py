"""Unified model configuration covering the 10 assigned architectures.

A model is a stack of *blocks*; each block has a token-mixing part
("attn" | "mla" | "rec" | "ssm") and a channel-mixing part ("mlp" | "moe").
Per-layer heterogeneity (gemma2 local/global alternation, recurrentgemma's
rec,rec,attn pattern, deepseek-v3's dense-then-MoE prefix) is expressed as a
layer pattern which the runtime compresses into (prefix, periodic-group)
segments so the forward pass can lax.scan over layer-stacked parameters.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

__all__ = [
    "AttentionConfig",
    "MLAConfig",
    "MoEConfig",
    "SSMConfig",
    "RGLRUConfig",
    "EncoderConfig",
    "PrefixVisionStub",
    "AudioFrontendStub",
    "BlockSpec",
    "ModelConfig",
    "segment_layers",
]


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None  # gemma2 attention logit softcap
    window: Optional[int] = None  # sliding window for "local" layers
    rope: bool = True  # whisper uses learned positions instead
    causal: bool = True


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25
    router_scale: bool = True  # normalise top-k gate weights to sum 1
    # mesh axes for the dispatch buffer (expert_dim, capacity_dim): aligning
    # the capacity dim with the token (data) axis turns GSPMD's giant
    # buffer all-reduces into local scatters + activation-sized all-to-alls
    dispatch_hint: Optional[Tuple] = None


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""

    width: int = 0  # lru width (defaults to d_model)
    conv_width: int = 4
    c: float = 8.0  # recurrence exponent scale


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (frontend stubbed to precomputed frames)."""

    n_layers: int
    n_frames: int  # encoder sequence length (e.g. 1500)
    d_model: int
    n_heads: int
    d_ff: int


@dataclass(frozen=True)
class PrefixVisionStub:
    """PaliGemma-style stub: input provides patch embeddings directly."""

    n_patches: int = 256
    d_embed: int = 0  # defaults to d_model


@dataclass(frozen=True)
class AudioFrontendStub:
    """Whisper-style stub: input provides audio frame embeddings directly."""

    n_frames: int = 1500


@dataclass(frozen=True)
class BlockSpec:
    """One layer's structure."""

    mixer: str  # "attn" | "attn_local" | "mla" | "rec" | "ssm"
    channel: str  # "mlp" | "moe" | "none"
    cross_attn: bool = False  # enc-dec decoder blocks


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttentionConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[PrefixVisionStub] = None
    audio: Optional[AudioFrontendStub] = None
    pattern: Tuple[str, ...] = ("attn",)  # mixer pattern, tiled over layers
    moe_start_layer: int = 0  # deepseek-v3: first k layers use dense MLP
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    scale_embed: bool = False  # gemma family: embeddings scaled by sqrt(d)
    mtp: bool = False  # deepseek-v3 multi-token-prediction head
    max_seq_len: int = 32768 + 8
    param_dtype: str = "float32"
    # whether full attention makes 500k-decode infeasible (roofline skip rule)
    subquadratic: bool = False
    # int8 KV cache with per-(token, kv-head) scales (decode memory-term win)
    kv_quant: bool = False
    # explicit per-layer structure override (dry-run segment variants)
    blocks_override: Optional[Tuple["BlockSpec", ...]] = None

    def block_specs(self) -> Tuple[BlockSpec, ...]:
        if self.blocks_override is not None:
            return self.blocks_override
        out = []
        for li in range(self.n_layers):
            mixer = self.pattern[li % len(self.pattern)]
            if self.moe is not None and li >= self.moe_start_layer and mixer != "ssm":
                channel = "moe"
            elif mixer == "ssm":
                channel = "none"  # mamba blocks carry their own projections
            else:
                channel = "mlp"
            out.append(
                BlockSpec(
                    mixer=mixer,
                    channel=channel,
                    cross_attn=(self.family == "encdec"),
                )
            )
        return tuple(out)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def segment_layers(specs: Sequence[BlockSpec]) -> list[tuple[tuple, int]]:
    """Compress the layer list into (superblock, repeat) segments.

    Finds, greedily from the left, maximal segments of the form
    ``superblock * repeat`` where superblock is a short tuple of BlockSpecs
    (period <= 4).  The forward pass scans each segment (stacked params with
    leading dim = repeat), so HLO size is O(#segments * period), not O(L).
    """
    segs: list[tuple[tuple, int]] = []
    i, L = 0, len(specs)
    while i < L:
        best = (tuple(specs[i : i + 1]), 1)
        for p in range(1, 5):
            if i + p > L:
                break
            block = tuple(specs[i : i + p])
            r = 1
            while i + (r + 1) * p <= L and tuple(
                specs[i + r * p : i + (r + 1) * p]
            ) == block:
                r += 1
            if r * p > best[1] * len(best[0]):
                best = (block, r)
        segs.append(best)
        i += len(best[0]) * best[1]
    return segs
