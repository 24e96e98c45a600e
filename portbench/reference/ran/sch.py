"""Shared-channel (SCH) derivations: TBS calculation and LDPC segmentation.

Exact-integer ports of TS 38.214 Section 5.1.3.2 (TBS) and TS 38.212
Section 5.2.2 (codeblock segmentation).
reference: lib/ran/sch/tbs_calculator.cpp, include/srsran/ran/sch/sch_segmentation.h,
lib/phy/upper/channel_coding/ldpc/ldpc_segmenter_impl.cpp

The port's own copy of `srsran_projectvtlmo_tpu.ran.sch`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .ldpc_params import BaseGraph, min_lifting_size

#: TS 38.214 Table 5.1.3.2-1: valid transport block sizes up to 3824 bits.
TBS_TABLE = (
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144, 152, 160,
    168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320, 336, 352, 368, 384,
    408, 432, 456, 480, 504, 528, 552, 576, 608, 640, 672, 704, 736, 768, 808, 848,
    888, 928, 984, 1032, 1064, 1128, 1160, 1192, 1224, 1256, 1288, 1320, 1352, 1416,
    1480, 1544, 1608, 1672, 1736, 1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280,
    2408, 2472, 2536, 2600, 2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496,
    3624, 3752, 3824,
)


def tbs_calculator(
    *,
    nof_re: int,
    target_code_rate: float,
    modulation_bits: int,
    nof_layers: int,
    tb_scaling_field: int = 0,
) -> int:
    """TS 38.214 Section 5.1.3.2 transport block size in bits."""
    scaling = 1.0 / (1 << tb_scaling_field)
    nof_info = scaling * nof_re * target_code_rate * modulation_bits * nof_layers

    if nof_info <= 3824:
        n = max(3, int(math.floor(math.log2(nof_info))) - 6)
        nof_info_prime = max(24, (1 << n) * int(nof_info / (1 << n)))
        for tbs in TBS_TABLE:
            if tbs >= nof_info_prime:
                return tbs
        return TBS_TABLE[-1]

    n = int(math.floor(math.log2(nof_info - 24))) - 5
    nof_info_prime = max(3840, (1 << n) * round((nof_info - 24) / (1 << n)))
    if target_code_rate <= 0.25:
        c = _ceil_div(nof_info_prime + 24, 3816)
        return 8 * c * _ceil_div(nof_info_prime + 24, 8 * c) - 24
    if nof_info_prime > 8424:
        c = _ceil_div(nof_info_prime + 24, 8424)
        return 8 * c * _ceil_div(nof_info_prime + 24, 8 * c) - 24
    return 8 * _ceil_div(nof_info_prime + 24, 8) - 24


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def choose_base_graph(tbs: int, target_code_rate: float) -> BaseGraph:
    """TS 38.212 Section 7.2.2 base-graph selection (A = TBS without TB CRC)."""
    if tbs <= 292 or (tbs <= 3824 and target_code_rate <= 0.67) or target_code_rate <= 0.25:
        return BaseGraph.BG2
    return BaseGraph.BG1


@dataclass(frozen=True)
class SchSegmentation:
    """Derived segmentation parameters for one transport block (TS 38.212 Section 5.2.2)."""

    base_graph: BaseGraph
    #: TB CRC length: 24 (A > 3824) or 16.
    tb_crc_bits: int
    #: Number of codeblocks C.
    nof_cb: int
    #: Lifting size Z_c.
    lifting_size: int
    #: Bits per codeblock including filler, K = 22Z (BG1) / 10Z (BG2).
    nof_bits_per_cb: int
    #: Payload bits per codeblock K' = B' / C (includes CB CRC when C > 1).
    nof_payload_bits_per_cb: int
    #: Filler bits per codeblock F = K - K'.
    nof_filler_bits_per_cb: int
    #: Full codeblock length after encoding, N = 66Z (BG1) / 50Z (BG2).
    nof_cw_bits_per_cb: int
    #: CB CRC length (24 when C > 1 else 0).
    cb_crc_bits: int

    @property
    def nof_info_bits(self) -> int:
        """Transport block + TB CRC bits, B."""
        b = self.nof_payload_bits_per_cb * self.nof_cb
        return b - self.cb_crc_bits * self.nof_cb if self.nof_cb > 1 else b


def sch_segmentation_info(tbs: int, target_code_rate: float) -> SchSegmentation:
    """Derive LDPC segmentation for a TB of `tbs` bits at `target_code_rate`."""
    bg = choose_base_graph(tbs, target_code_rate)
    tb_crc = 24 if tbs > 3824 else 16
    b = tbs + tb_crc

    k_cb = 8448 if bg == BaseGraph.BG1 else 3840
    if b <= k_cb:
        c = 1
        b_prime = b
        cb_crc = 0
    else:
        c = _ceil_div(b, k_cb - 24)
        b_prime = b + c * 24
        cb_crc = 24
    k_prime = b_prime // c
    assert b_prime % c == 0 or True  # K' = ceil when not divisible (padding handled by filler)
    k_prime = _ceil_div(b_prime, c)

    if bg == BaseGraph.BG1:
        kb = 22
    else:
        if b > 640:
            kb = 10
        elif b > 560:
            kb = 9
        elif b > 192:
            kb = 8
        else:
            kb = 6

    z = min_lifting_size(kb, k_prime)
    k = 22 * z if bg == BaseGraph.BG1 else 10 * z
    n = 66 * z if bg == BaseGraph.BG1 else 50 * z

    return SchSegmentation(
        base_graph=bg,
        tb_crc_bits=tb_crc,
        nof_cb=c,
        lifting_size=z,
        nof_bits_per_cb=k,
        nof_payload_bits_per_cb=k_prime,
        nof_filler_bits_per_cb=k - k_prime,
        nof_cw_bits_per_cb=n,
        cb_crc_bits=cb_crc,
    )
