"""PRACH configuration index tables (TS 38.211 Tables 6.3.3.2-2/3).

prach-ConfigurationIndex -> preamble format, SFN period/offset, subframes,
starting symbol, slots/occasions per slot, duration.
reference: lib/ran/prach/prach_configuration.cpp, include/srsran/ran/prach/
prach_configuration.h:40-57.

The port's own copy of `srsran_projectvtlmo_tpu.ran.prach_config`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

_DATA = Path(__file__).resolve().parent.parent / "data" / "prach_config_tables.json"

#: Long preamble formats occupy L=839 at 1.25/5 kHz; short formats L=139.
LONG_FORMATS = {"zero", "one", "two", "three"}


@dataclass(frozen=True)
class PrachConfiguration:
    format: str
    x: int | None                    # SFN period
    y: int | None                    # SFN offset
    subframes: tuple[int, ...]
    starting_symbol: int
    nof_prach_slots_within_subframe: int
    nof_occasions_within_slot: int
    duration: int

    @property
    def is_long(self) -> bool:
        return self.format in LONG_FORMATS

    @property
    def is_reserved(self) -> bool:
        return self.format == "invalid"

    def occasion_in_sfn(self, sfn: int) -> bool:
        if self.x is None:
            return False
        return sfn % self.x == (self.y or 0)


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    return json.loads(_DATA.read_text())


def prach_configuration(duplex: str, prach_config_index: int) -> PrachConfiguration:
    """duplex in {'fr1_paired', 'fr1_unpaired'}."""
    row = _tables()[duplex][prach_config_index]
    return PrachConfiguration(
        format=row["format"], x=row["x"], y=row["y"],
        subframes=tuple(row["subframes"]),
        starting_symbol=row["starting_symbol"],
        nof_prach_slots_within_subframe=row["nof_prach_slots_within_subframe"],
        nof_occasions_within_slot=row["nof_occasions_within_slot"],
        duration=row["duration"],
    )
