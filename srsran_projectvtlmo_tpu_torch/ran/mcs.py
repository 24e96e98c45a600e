"""MCS index tables (TS 38.214 Tables 5.1.3.1-1 / 5.1.3.1-2).

mcs -> (modulation, target code rate R = x/1024).
reference: include/srsran/ran/sch/sch_mcs.h, lib/ran/sch/sch_mcs.cpp.
"""

from __future__ import annotations

from .modulation import Modulation

#: Table 5.1.3.1-1 (qam64): (Qm, R*1024).
_TABLE1 = (
    (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449), (2, 526),
    (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490), (4, 553), (4, 616),
    (4, 658), (6, 438), (6, 466), (6, 517), (6, 567), (6, 616), (6, 666), (6, 719),
    (6, 772), (6, 822), (6, 873), (6, 910), (6, 948),
)

#: Table 5.1.3.1-2 (qam256): (Qm, R*1024).
_TABLE2 = (
    (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567), (6, 616), (6, 666),
    (6, 719), (6, 772), (6, 822), (6, 873), (8, 682.5), (8, 711), (8, 754), (8, 797),
    (8, 841), (8, 885), (8, 916.5), (8, 948),
)

_QM_TO_MOD = {2: Modulation.QPSK, 4: Modulation.QAM16, 6: Modulation.QAM64, 8: Modulation.QAM256}


def mcs_to_modulation_and_rate(mcs: int, table: str = "qam64") -> tuple[Modulation, float]:
    """Returns (modulation, target code rate) for an MCS index."""
    tbl = _TABLE1 if table == "qam64" else _TABLE2
    if not 0 <= mcs < len(tbl):
        raise ValueError(f"MCS {mcs} out of range for table {table}")
    qm, r1024 = tbl[mcs]
    return _QM_TO_MOD[qm], r1024 / 1024.0
