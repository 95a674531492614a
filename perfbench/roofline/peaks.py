"""Published peaks of the cards a run may land on (NVIDIA's data sheets,
dense rates without sparsity), keyed by ``torch.cuda.get_device_name()``.
A share of a peak is stated against these, with the card's power limit
printed beside it."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"part": "H100 SXM", "bf16_flops": 989e12,
                              "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The card's peaks, or None for a card the table does not know (a
    share of its peak is then not reported)."""
    return PEAKS.get(device_name)
