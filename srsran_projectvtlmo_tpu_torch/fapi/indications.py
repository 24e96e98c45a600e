"""The port's uplink result indications that carry more than the FAPI copy's.

`fapi/pdus.py` is a copy held equal in code to the JAX package's file, so the
port's additions live here.  `CrcIndication` keeps the copy's class name and
fields and adds the channel state the reference's CRC.indication reports for
each PUSCH (SCF FAPI CRC.indication; srsRAN `fapi::crc_pdu`: UL SINR metric,
timing advance offset in ns): the scheduler runs UL link adaptation on the
SINR, and its TA manager issues TA commands from the offset.  Being a
subclass of the copy's class, every `isinstance` check and every comparison
of class names keeps working.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import pdus

#: The channel-state fields `CrcIndication` adds to the FAPI copy's.
CHANNEL_STATE = ("ul_sinr_db", "timing_advance_ns", "evm")


@dataclass
class CrcIndication(pdus.CrcIndication):
    """One PUSCH's CRC verdict with its channel state, as the receiver
    measured it on the slot: the post-equalization SINR in dB (the mean over
    subcarriers and layers of the linear SINR), the timing advance offset in
    ns (positive: the UE's signal arrives late) and the EVM of the equalized
    data symbols (RMS, unit-power constellation)."""

    ul_sinr_db: float
    timing_advance_ns: float
    evm: float
