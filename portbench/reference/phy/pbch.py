"""PBCH channel coding, TS 38.212 Section 7.1: payload interleaving, the
first scrambling, CRC24C, polar K=56 E=864 (the coding part of a frozen
copy of the port's `phy/pbch`, itself a port of
`srsran_projectvtlmo_tpu.phy.pbch`).
reference: lib/phy/upper/channel_processors/pbch_encoder_impl.cpp:32-160.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import prg as prg_mod
from ..ops.crc import crc_host
from ..ops.polar import PolarCode, polar_allocate, polar_encode
from ..ops.polar import rate_matching as polar_rm
from ..ops.polar.interleave import interleave

A = 32          # payload bits
B = A + 24      # payload + CRC24C
E = 864         # rate-matched bits

#: TS 38.212 Table 7.1.1-1: PBCH payload interleaver pattern G(j).
G = np.asarray([16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
                9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28, 29, 31])


@dataclass(frozen=True)
class PbchMessage:
    sfn: int
    ssb_idx: int
    half_radio_frame: bool
    n_id: int  # physical cell id
    l_max: int = 8
    #: 24-bit MIB-derived part of the payload (bits a_1..a_24 before SFN/HRF/SSB fields).
    mib_payload: tuple[int, ...] = tuple([0] * 24)
    #: Subcarrier offset k_SSB (TS 38.211 Section 7.4.3.1); its MSB rides in
    #: the payload when L_max != 64 (reference: pbch_encoder_impl.cpp:75).
    k_ssb: int = 0


def pbch_payload(msg: PbchMessage) -> np.ndarray:
    """Build the interleaved 32-bit payload a (TS 38.212 Section 7.1.1)."""
    a = np.zeros(A, dtype=np.uint8)
    payload = list(msg.mib_payload)
    # 24 MIB bits + 4 SFN LSBs + HRF + 3 SSB/k_ssb bits = 32.
    j_sfn = 0
    j_other = 14
    sfn_begin, sfn_len = 1, 6
    for i in range(A - 8):
        if sfn_begin <= i < sfn_begin + sfn_len:
            a[G[j_sfn]] = payload[i]
            j_sfn += 1
        else:
            a[G[j_other]] = payload[i]
            j_other += 1
    a[G[j_sfn]] = (msg.sfn >> 3) & 1
    a[G[j_sfn + 1]] = (msg.sfn >> 2) & 1
    a[G[j_sfn + 2]] = (msg.sfn >> 1) & 1
    a[G[j_sfn + 3]] = msg.sfn & 1
    a[G[10]] = 1 if msg.half_radio_frame else 0
    if msg.l_max == 64:
        a[G[11]] = (msg.ssb_idx >> 5) & 1
        a[G[12]] = (msg.ssb_idx >> 4) & 1
        a[G[13]] = (msg.ssb_idx >> 3) & 1
    else:
        # The MSB of k_SSB (the reference's fix, pbch_encoder_impl.cpp:75).
        a[G[11]] = (msg.k_ssb >> 4) & 1
        a[G[12]] = 0  # reserved
        a[G[13]] = 0
    return a


def pbch_scramble_payload(a: np.ndarray, msg: PbchMessage) -> np.ndarray:
    """First scrambling (TS 38.212 Section 7.1.2): skips SFN 2nd/3rd LSBs, HRF, SSB bits."""
    m = A - 6 if msg.l_max == 64 else A - 3
    sfn_2nd_g = G[6 + 2]
    sfn_3rd_g = G[6 + 1]
    v = 2 * a[sfn_3rd_g] + a[sfn_2nd_g]
    seq = prg_mod.gold_sequence_bits(msg.n_id, m * v + A)[m * v:]
    out = a.copy()
    j = 0
    for i in range(A):
        is_ssb = (i in (G[11], G[12], G[13])) and msg.l_max == 64
        if is_ssb or i == G[10] or i == sfn_2nd_g or i == sfn_3rd_g:
            s = 0
        else:
            s = seq[j]
            j += 1
        out[i] ^= s
    return out


def pbch_encode(msg: PbchMessage) -> np.ndarray:
    """Full PBCH encode -> (E,) bits (before the second, E-level scrambling)."""
    a = pbch_payload(msg)
    a_prime = pbch_scramble_payload(a, msg)
    b = np.concatenate([a_prime, crc_host(a_prime, "CRC24C")])
    code = PolarCode(K=B, E=E, n_max=9, ibil=False)
    u = polar_allocate(interleave(torch.as_tensor(b[None]), B), code)
    return polar_rm.rate_match(polar_encode(u, code.n), code)[0].numpy()
