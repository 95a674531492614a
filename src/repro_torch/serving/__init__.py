"""Serving substrate: the calibrated iteration-level cluster engine.

The real-compute data plane (steps, engine, cluster) is ROADMAP A10.
"""

from .engine_sim import ClusterEngine, EngineConfig, EngineMetrics  # noqa: F401
