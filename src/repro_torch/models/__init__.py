"""Model substrate: configs and parameter-shape trees.

Only the shape half of the reference's model code is here (``*_defs``,
``model_defs``, parameter counts); the forwards are ROADMAP A10.
"""

from .config import ModelConfig  # noqa: F401
from .model import active_param_count, model_defs, param_count  # noqa: F401
