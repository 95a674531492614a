from .ops import decode_attention, decode_attention_plain  # noqa: F401
