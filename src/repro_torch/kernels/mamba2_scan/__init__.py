from .ops import ssd_scan
from .ref import ssd_recurrent_ref, ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_recurrent_ref"]
