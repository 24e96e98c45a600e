"""Modulation scheme enumeration (TS 38.211).

reference: include/srsran/ran/sch/modulation_scheme.h

The port's own copy of `srsran_projectvtlmo_tpu.ran.modulation`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import enum


class Modulation(enum.Enum):
    PI_2_BPSK = "pi/2-BPSK"
    BPSK = "BPSK"
    QPSK = "QPSK"
    QAM16 = "16QAM"
    QAM64 = "64QAM"
    QAM256 = "256QAM"


_BITS = {
    Modulation.PI_2_BPSK: 1,
    Modulation.BPSK: 1,
    Modulation.QPSK: 2,
    Modulation.QAM16: 4,
    Modulation.QAM64: 6,
    Modulation.QAM256: 8,
}


def bits_per_symbol(mod: Modulation) -> int:
    return _BITS[mod]
