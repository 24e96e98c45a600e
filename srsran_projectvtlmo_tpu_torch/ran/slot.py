"""Slot point arithmetic (numerology-aware system time).

reference: include/srsran/ran/slot_point.h -- a slot index within the 1024-frame
hyperframe, with numerology-scaled slots per frame.
"""

from __future__ import annotations

from dataclasses import dataclass

NOF_SFNS = 1024
NOF_SUBFRAMES_PER_FRAME = 10


@dataclass(frozen=True, order=False)
class SlotPoint:
    numerology: int
    count: int  # slot count within the hyperframe

    def __post_init__(self):
        assert 0 <= self.numerology <= 4
        object.__setattr__(self, "count", self.count % self.nof_slots_per_hyperframe)

    @property
    def slots_per_subframe(self) -> int:
        return 1 << self.numerology

    @property
    def slots_per_frame(self) -> int:
        return NOF_SUBFRAMES_PER_FRAME * self.slots_per_subframe

    @property
    def nof_slots_per_hyperframe(self) -> int:
        return NOF_SFNS * self.slots_per_frame

    @property
    def sfn(self) -> int:
        return self.count // self.slots_per_frame

    @property
    def slot_index(self) -> int:
        """Slot within the frame."""
        return self.count % self.slots_per_frame

    @property
    def subframe_index(self) -> int:
        return self.slot_index // self.slots_per_subframe

    @property
    def slot_in_subframe(self) -> int:
        return self.slot_index % self.slots_per_subframe

    def __add__(self, n: int) -> "SlotPoint":
        return SlotPoint(self.numerology, self.count + n)

    def __sub__(self, other) -> int:
        if isinstance(other, SlotPoint):
            d = (self.count - other.count) % self.nof_slots_per_hyperframe
            half = self.nof_slots_per_hyperframe // 2
            return d - self.nof_slots_per_hyperframe if d >= half else d
        return NotImplemented

    def __lt__(self, other: "SlotPoint") -> bool:
        return (other - self) > 0
