from .ops import prefill_attention, prefill_attention_plain  # noqa: F401
