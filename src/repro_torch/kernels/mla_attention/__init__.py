from .ops import mla_attention, mla_attention_plain  # noqa: F401
