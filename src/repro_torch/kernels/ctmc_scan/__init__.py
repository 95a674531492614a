from .ops import ctmc_scan, ctmc_scan_plain  # noqa: F401
