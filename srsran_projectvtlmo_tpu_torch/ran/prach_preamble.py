"""PRACH preamble format parameters (TS 38.211 Tables 6.3.3.1-1/2).

Exact-integer port of the reference's preamble information
(reference: lib/ran/prach/prach_preamble_information.cpp:30-118): sequence
length, RA subcarrier spacing, number of repeated preamble symbols and cyclic
prefix length per format.  CP lengths are in units of kappa*Tc
(kappa = 64, Tc = 1/(480 kHz * 4096)).

The port's own copy of `srsran_projectvtlmo_tpu.ran.prach_preamble`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

#: seconds per kappa*Tc unit.
KAPPA_TC_S = 64.0 / (480e3 * 4096)

LONG_FORMATS = ("0", "1", "2", "3")
SHORT_FORMATS = ("A1", "A2", "A3", "B1", "B4", "C0", "C2", "A1_B1", "A2_B2", "A3_B3")

#: format -> (nof_symbols, cp_kappa_at_mu0) for short preambles; actual CP is
#: cp_kappa >> numerology.
_SHORT = {
    "A1": (2, 288), "A2": (4, 576), "A3": (6, 864),
    "B1": (2, 216), "B4": (12, 936), "C0": (1, 1240), "C2": (4, 2048),
    # Mixed A/B formats use the A CP except on the last occasion.
    "A1_B1": (2, 288), "A2_B2": (4, 576), "A3_B3": (6, 864),
}


@dataclass(frozen=True)
class PrachPreambleInfo:
    sequence_length: int
    scs_hz: float
    nof_symbols: int
    cp_length_s: float

    @property
    def cp_prach(self) -> int:
        """CP length in sequence-sample units: floor(T_cp * L * scs)
        (reference: prach_detector_generic_impl.cpp:98)."""
        import math
        return int(math.floor(self.cp_length_s * self.sequence_length * self.scs_hz))


def preamble_info(fmt: str, numerology: int = 0) -> PrachPreambleInfo:
    """Preamble parameters for a format; numerology applies to short formats
    (RA SCS = 15 kHz << numerology)."""
    if fmt == "0":
        return PrachPreambleInfo(839, 1.25e3, 1, 3168 * KAPPA_TC_S)
    if fmt == "1":
        return PrachPreambleInfo(839, 1.25e3, 2, 21024 * KAPPA_TC_S)
    if fmt == "2":
        return PrachPreambleInfo(839, 1.25e3, 4, 4688 * KAPPA_TC_S)
    if fmt == "3":
        return PrachPreambleInfo(839, 5e3, 4, 3168 * KAPPA_TC_S)
    if fmt in _SHORT:
        nsym, cpk = _SHORT[fmt]
        return PrachPreambleInfo(139, 15e3 * (1 << numerology), nsym,
                                 (cpk >> numerology) * KAPPA_TC_S)
    raise ValueError(f"unknown PRACH format {fmt!r}")
