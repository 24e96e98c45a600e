"""Receive-side fronthaul integrity checks.

reference: lib/ofh/receiver/ofh_sequence_id_checker_impl.h:40-100 (mod-256
wraparound sequence distance per eAxC) and ofh_rx_window_checker.cpp:28-128
(symbol-point distance vs the [sym_start, sym_end] reception window derived
from Ta4_min/Ta4_max, with the OFH 256-SFN wrap).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ran.slot import NOF_SUBFRAMES_PER_FRAME

#: OFH frame counter is one byte (rx_window_checker.cpp:28).
OFH_MAX_NOF_SFN = 256


class SequenceIdChecker:
    """Per-eAxC eCPRI sequence-id tracker.

    update_and_compare(eaxc, seq_id) returns 0 when the message is in order,
    a negative count when it is from the past (duplicate/reordered), and the
    number of skipped identifiers when messages were lost — in which case the
    expected counter resyncs to the received id
    (reference: ofh_sequence_id_checker_impl.h:52-100).
    """

    NOF_IDS = 256

    def __init__(self):
        self._counters: dict[int, int] = {}

    def update_and_compare(self, eaxc: int, seq_id: int) -> int:
        seq_id &= 0xFF
        if eaxc not in self._counters:
            self._counters[eaxc] = seq_id
            return 0
        expected = (self._counters[eaxc] + 1) % self.NOF_IDS
        if seq_id == expected:
            self._counters[eaxc] = expected
            return 0
        d = seq_id - expected
        if d >= self.NOF_IDS // 2:
            d -= self.NOF_IDS
        elif d < -self.NOF_IDS // 2:
            d += self.NOF_IDS
        if d > 0:
            self._counters[eaxc] = seq_id
        return d


@dataclass
class RxWindowStats:
    on_time: int = 0
    early: int = 0
    late: int = 0


@dataclass
class RxWindowChecker:
    """Checks uplink message arrival against the reception window.

    The OTA (over-the-air) symbol point advances with on_new_symbol(); each
    received message's symbol point is compared against it: the distance in
    symbols must lie inside [sym_start, sym_end] (both derived from the RU's
    Ta4 min/max transmission advance), else the message counts early/late
    (reference: ofh_rx_window_checker.cpp:74-117).
    """

    numerology: int
    sym_start: int
    sym_end: int
    symbols_per_slot: int = 14
    stats: RxWindowStats = field(default_factory=RxWindowStats)
    _ota_count: int = 0

    @property
    def _wrap(self) -> int:
        slots_per_subframe = 1 << self.numerology
        return (OFH_MAX_NOF_SFN * NOF_SUBFRAMES_PER_FRAME * slots_per_subframe
                * self.symbols_per_slot)

    def symbol_count(self, sfn: int, slot_index: int, symbol: int) -> int:
        """Global symbol index with the OFH one-byte SFN wrap."""
        slots_per_frame = NOF_SUBFRAMES_PER_FRAME * (1 << self.numerology)
        return (((sfn % OFH_MAX_NOF_SFN) * slots_per_frame + slot_index)
                * self.symbols_per_slot + symbol) % self._wrap

    def on_new_symbol(self, sfn: int, slot_index: int, symbol: int) -> None:
        self._ota_count = self.symbol_count(sfn, slot_index, symbol)

    def check(self, sfn: int, slot_index: int, symbol: int) -> str:
        """Classify one received message: 'on_time' | 'early' | 'late'."""
        msg = self.symbol_count(sfn, slot_index, symbol)
        diff = self._ota_count - msg
        half = self._wrap // 2
        if diff >= half:
            diff -= self._wrap
        elif diff < -half:
            diff += self._wrap
        if diff > self.sym_end:
            self.stats.late += 1
            return "late"
        if diff < self.sym_start:
            self.stats.early += 1
            return "early"
        self.stats.on_time += 1
        return "on_time"
