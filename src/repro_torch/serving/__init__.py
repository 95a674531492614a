"""Serving substrate: the real-compute data plane (steps, engine,
cluster), the calibrated iteration-level cluster engine, and its batched
trace-replay twins (``ClusterEngineJAX``, streamed ``StreamingEngineJAX``).

The data plane serves every config's mixers and channels: attention
(global, local ring and int8 caches), MLA (latent and int8 caches),
RG-LRU, SSM, the MLP and the capacity-dispatch MoE.  The step functions
take the encoder's frames and the prefix embeddings; the engine, as the
reference's, passes neither, so it serves prefix-LM models text only and
refuses an encoder-decoder (ROADMAP C-ref7).
"""

from .cluster import ClusterMetrics, RealCluster  # noqa: F401
from .engine import ServerEngine, SlotRequest  # noqa: F401
from .engine_jax import ClusterEngineJAX  # noqa: F401
from .engine_sim import ClusterEngine, EngineConfig, EngineMetrics  # noqa: F401
from .engine_stream import StreamingEngineJAX, TraceChunkSource  # noqa: F401
from .steps import (  # noqa: F401
    greedy_sample,
    init_server_state,
    make_decode_step,
    make_mixed_step,
    make_prefill_step,
)
