"""PRACH cyclic shift (N_cs) tables, TS 38.211 Tables 6.3.3.1-5/6/7.

Full lib/ran parity: all three restricted-set columns with the reserved
entries (reference: lib/ran/prach/prach_cyclic_shifts.cpp:30-120). Note the
reference's PHY preamble generator itself only implements the unrestricted
set (prach_generator_impl.cpp:260 asserts); the detector/generator here
mirror that envelope, but the tables are complete for configuration
validation and L2 interoperability.

The port's own copy of `srsran_projectvtlmo_tpu.ran.prach_cyclic_shifts`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

from enum import Enum

#: Sentinel for invalid (reserved) table entries
#: (reference: include/srsran/ran/prach/prach_cyclic_shifts.h).
PRACH_CYCLIC_SHIFTS_RESERVED = 0xFFFF


class RestrictedSetConfig(Enum):
    UNRESTRICTED = 0
    TYPE_A = 1
    TYPE_B = 2


_R = PRACH_CYCLIC_SHIFTS_RESERVED

# TS 38.211 Table 6.3.3.1-5 (1.25 kHz PRACH SCS), columns by restricted set.
_TABLE_1_25 = {
    RestrictedSetConfig.UNRESTRICTED:
        (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419),
    RestrictedSetConfig.TYPE_A:
        (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158, 202, 237, _R),
    RestrictedSetConfig.TYPE_B:
        (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 118, 137, _R, _R, _R),
}

# TS 38.211 Table 6.3.3.1-6 (5 kHz PRACH SCS).
_TABLE_5 = {
    RestrictedSetConfig.UNRESTRICTED:
        (0, 13, 26, 33, 38, 41, 49, 55, 64, 76, 93, 119, 139, 209, 279, 419),
    RestrictedSetConfig.TYPE_A:
        (36, 57, 72, 81, 89, 94, 103, 112, 121, 132, 137, 152, 173, 195, 216, 237),
    RestrictedSetConfig.TYPE_B:
        (36, 57, 60, 63, 65, 68, 71, 77, 81, 85, 97, 109, 122, 137, _R, _R),
}

# TS 38.211 Table 6.3.3.1-7 (15 kHz and above, short preambles):
# unrestricted only.
_TABLE_OTHER = {
    RestrictedSetConfig.UNRESTRICTED:
        (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69),
}


def prach_cyclic_shifts_get(prach_scs: str,
                            restricted_set: RestrictedSetConfig,
                            zero_correlation_zone: int) -> int:
    """N_cs for (PRACH SCS, restricted set, zeroCorrelationZone).

    prach_scs: '1.25kHz', '5kHz', or any short-preamble SCS ('15kHz',
    '30kHz', '60kHz', '120kHz'). Returns PRACH_CYCLIC_SHIFTS_RESERVED for
    invalid combinations, as the reference does.
    """
    if prach_scs == "1.25kHz":
        table = _TABLE_1_25.get(restricted_set)
    elif prach_scs == "5kHz":
        table = _TABLE_5.get(restricted_set)
    else:
        table = _TABLE_OTHER.get(restricted_set)
    if table is None or not (0 <= zero_correlation_zone < len(table)):
        return PRACH_CYCLIC_SHIFTS_RESERVED
    return table[zero_correlation_zone]
