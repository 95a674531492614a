"""Model substrate: configs, params, mixers, and the unified LM.

The forwards serve every mixer of the ten configs (``attn``/
``attn_local``, ``mla``, ``rec``, ``ssm``), the MLP and MoE channels,
cross-attention with the encoder and prefix-LM; ``forward_train`` and
``loss_fn`` train them under autograd.
"""

from .config import ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    active_param_count,
    encoder_forward,
    forward_decode,
    forward_prefill,
    forward_train,
    init_cache,
    init_model,
    loss_fn,
    model_defs,
    param_count,
)
from .params import init_params, params_from_numpy  # noqa: F401
