"""Upper-PHY error handling: late/failed slot accounting.

reference: lib/phy/upper/upper_phy_error_handler_impl.cpp (error notifier for
late or failed slots), lib/phy/lower error notifier (late resource grids,
radio overflow/underflow).  The device pipeline's analog of a "late slot" is a
slot whose device program missed its deadline; the handler records it and
invokes a notifier callback.

The port's own copy of `srsran_projectvtlmo_tpu.phy.error_handler`, its code
unchanged; tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class SlotErrorStats:
    late_dl: int = 0
    late_ul: int = 0
    failed: int = 0


class UpperPhyErrorHandler:
    def __init__(self, slot_duration_s: float, on_error=None):
        self.slot_duration_s = slot_duration_s
        self.stats = SlotErrorStats()
        self._on_error = on_error or (lambda kind, slot, latency: None)

    def check_dl_deadline(self, slot: int, started_at: float) -> bool:
        """Returns True when the slot met its deadline; records lateness otherwise."""
        latency = time.perf_counter() - started_at
        if latency > self.slot_duration_s:
            self.stats.late_dl += 1
            self._on_error("late_dl", slot, latency)
            return False
        return True

    def check_ul_deadline(self, slot: int, started_at: float) -> bool:
        latency = time.perf_counter() - started_at
        if latency > self.slot_duration_s:
            self.stats.late_ul += 1
            self._on_error("late_ul", slot, latency)
            return False
        return True

    def on_failure(self, slot: int, exc: Exception) -> None:
        self.stats.failed += 1
        self._on_error("failed", slot, 0.0)
