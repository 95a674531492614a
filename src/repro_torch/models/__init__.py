"""Model substrate: configs, params, mixers, and the unified LM.

The forwards serve the ``attn``/``attn_local``, ``rec`` and ``ssm``
mixers; MLA, MoE, cross-attention with the encoder and prefix-LM are
ROADMAP A10, training ROADMAP A12.
"""

from .config import ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    active_param_count,
    forward_decode,
    forward_prefill,
    init_cache,
    init_model,
    model_defs,
    param_count,
)
from .params import init_params, params_from_numpy  # noqa: F401
