from .ops import ssd_scan, ssd_scan_plain  # noqa: F401
