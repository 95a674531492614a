"""Serving substrate: the real-compute data plane (steps, engine,
cluster) and the calibrated iteration-level cluster engine.

The data plane serves the attention (global, local ring and int8
caches), RG-LRU and SSM mixers; MLA, MoE, cross-attention and prefix-LM
models raise until the rest of ROADMAP A10.
"""

from .cluster import ClusterMetrics, RealCluster  # noqa: F401
from .engine import ServerEngine, SlotRequest  # noqa: F401
from .engine_sim import ClusterEngine, EngineConfig, EngineMetrics  # noqa: F401
from .steps import (  # noqa: F401
    greedy_sample,
    init_server_state,
    make_decode_step,
    make_mixed_step,
    make_prefill_step,
)
