"""SS/PBCH block generation: PSS, SSS, PBCH encode + modulate, SSB assembly
(port of `srsran_projectvtlmo_tpu.phy.pbch`, bit-exact with it).

TS 38.211 Sections 7.4.2.2/7.4.2.3 (PSS/SSS m-sequences), TS 38.212
Section 7.1 (PBCH payload interleaving, scrambling, CRC24C, polar K=56 E=864),
TS 38.211 Section 7.4.3 (SS/PBCH block: 240 subcarriers x 4 symbols).
Host work, numpy: the chain from the scrambled payload a' to the 864 bits
is linear over GF(2), so it runs once per payload bit to build an encode
table (`ops.gf2`) and every encode is a lookup; a block's PSS, SSS,
DM-RS and PBCH RE positions depend on the cell alone (PCI, SS/PBCH block
index, half-frame bit, L_max) and are kept, so a slot writes its 432 QPSK
symbols into a copy.  The DL slot adds the block to the grid on the device.
reference: lib/phy/upper/channel_processors/pbch_encoder_impl.cpp:32-160,
pbch_modulator_impl.cpp, ssb_processor_impl.cpp.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import gf2
from ..ops import prg as prg_mod
from ..ops.crc import crc_host
from ..ops.polar import PolarCode, polar_allocate, polar_encode
from ..ops.polar import rate_matching as polar_rm
from ..ops.polar.interleave import interleave
from ..utils import tracing
from ..utils.cplx import np_to_pair
from .pdcch import qpsk_pairs

A = 32          # payload bits
B = A + 24      # payload + CRC24C
E = 864         # rate-matched bits
SSB_NSUBC = 240
SSB_NSYM = 4

#: TS 38.212 Table 7.1.1-1: PBCH payload interleaver pattern G(j).
G = np.asarray([16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
                9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28, 29, 31])


def _mseq(taps: tuple[int, int], init: list[int]) -> np.ndarray:
    x = np.zeros(127 + 7, dtype=np.uint8)
    x[:7] = init
    for i in range(127):
        x[i + 7] = x[i + taps[0]] ^ x[i + taps[1]]
    return x[:127]


_PSS_X = _mseq((4, 0), [0, 1, 1, 0, 1, 1, 1])
_SSS_X0 = _mseq((4, 0), [1, 0, 0, 0, 0, 0, 0])
_SSS_X1 = _mseq((1, 0), [1, 0, 0, 0, 0, 0, 0])


def pss_sequence(n_id2: int) -> np.ndarray:
    n = (np.arange(127) + 43 * n_id2) % 127
    return (1.0 - 2.0 * _PSS_X[n]).astype(np.complex64)


def sss_sequence(n_id1: int, n_id2: int) -> np.ndarray:
    m0 = 15 * (n_id1 // 112) + 5 * n_id2
    m1 = n_id1 % 112
    n = np.arange(127)
    d = (1 - 2 * _SSS_X0[(n + m0) % 127].astype(np.int32)) * \
        (1 - 2 * _SSS_X1[(n + m1) % 127].astype(np.int32))
    return d.astype(np.complex64)


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


#: Where the payload's 24 MIB-derived bits go: a_1..a_6 (the SFN's MSBs) at
#: G(0..5), the others at G(14..31), in order.
_MIB_POS = G[np.r_[14, 0:6, 15:32]]
_SHIFTS4 = np.arange(3, -1, -1)
_SHIFTS3 = np.arange(5, 2, -1)


def pbch_payload(msg: PbchMessage) -> np.ndarray:
    """Build the interleaved 32-bit payload a (TS 38.212 Section 7.1.1)."""
    a = np.zeros(A, dtype=np.uint8)
    # 24 MIB bits + 4 SFN LSBs + HRF + 3 SSB/k_ssb bits = 32.
    a[_MIB_POS] = msg.mib_payload[:A - 8]
    a[G[6:10]] = (msg.sfn >> _SHIFTS4) & 1
    a[G[10]] = 1 if msg.half_radio_frame else 0
    if msg.l_max == 64:
        a[G[11:14]] = (msg.ssb_idx >> _SHIFTS3) & 1
    else:
        # The MSB of k_SSB (the reference's fix, pbch_encoder_impl.cpp:75);
        # G(12) and G(13) reserved, 0.
        a[G[11]] = (msg.k_ssb >> 4) & 1
    return a


@functools.lru_cache(maxsize=64)
def _first_scrambling(n_id: int, l_max: int) -> tuple[int, np.ndarray, np.ndarray]:
    """(M, the payload positions that are scrambled, in order; the Gold bits
    of c_init = N_id that any SFN offset v in 0..3 reads: 3 M + A)."""
    skip = {G[10], G[6 + 2], G[6 + 1]} | ({G[11], G[12], G[13]} if l_max == 64 else set())
    m = A - len(skip)
    pos = np.asarray([i for i in range(A) if i not in skip], np.int64)
    return m, pos, prg_mod.gold_sequence_bits(n_id, 3 * m + A)


def pbch_scramble_payload(a: np.ndarray, msg: PbchMessage) -> np.ndarray:
    """First scrambling (TS 38.212 Section 7.1.2): skips SFN 2nd/3rd LSBs, HRF,
    SSB bits; the sequence starts at M v, v the SFN's 3rd and 2nd LSBs."""
    m, pos, seq = _first_scrambling(msg.n_id, msg.l_max)
    v = 2 * int(a[G[6 + 1]]) + int(a[G[6 + 2]])
    out = a.copy()
    out[pos] ^= seq[m * v:m * v + len(pos)]
    return out


def _encode_chain(a_prime: np.ndarray) -> np.ndarray:
    """The encoder's bit chain from the scrambled payload a' to the E bits:
    CRC24C, interleaver, polar, rate match (what the encode table is built
    from, and what the tests hold it against)."""
    b = np.concatenate([a_prime, crc_host(a_prime, "CRC24C")])
    code = PolarCode(K=B, E=E, n_max=9, ibil=False)
    u = polar_allocate(interleave(torch.as_tensor(b[None]), B), code)
    return polar_rm.rate_match(polar_encode(u, code.n), code)[0].numpy()


#: The encode table of `_encode_chain` (one shape: K = 56, E = 864).
TABLES = gf2.TableCache(lambda: gf2.build_table(_encode_chain, A))


def _encode_packed(msg: PbchMessage) -> np.ndarray:
    """`pbch_encode`'s bits packed (`ops.gf2` words); counts
    `dl_encodes`, and `dl_table_encodes` where the table was already built."""
    table, built = TABLES.get()
    tracing.count("dl_encodes", 1)
    tracing.count("dl_table_encodes", int(built))
    return table.encode(pbch_scramble_payload(pbch_payload(msg), msg))


def pbch_encode(msg: PbchMessage) -> np.ndarray:
    """Full PBCH encode -> (E,) bits (before the second, E-level scrambling)."""
    return gf2.unpack(_encode_packed(msg), E)


@functools.lru_cache(maxsize=64)
def _second_scrambling(n_id: int, v: int) -> np.ndarray:
    """The Gold words of c_init = N_id from bit E v on, (E / 32,) uint32: the
    codeword is whole words, so the offset is too."""
    return prg_mod.gold_sequence_packed(n_id, E * (v + 1))[E // 32 * v:]


def pbch_symbol_pairs(msg: PbchMessage) -> np.ndarray:
    """Encode + second scrambling + QPSK -> (432, 2) float32 symbol pairs."""
    # TS 38.211 Section 7.3.3.1: v = 2 (L_max=4) or 3 LSBs of the SSB index.
    v = msg.ssb_idx % 4 if msg.l_max == 4 else msg.ssb_idx % 8
    return qpsk_pairs(gf2.unpack(_encode_packed(msg) ^ _second_scrambling(msg.n_id, v), E))


def pbch_modulate(msg: PbchMessage) -> np.ndarray:
    """Encode + second scrambling + QPSK -> (432,) symbols."""
    return pbch_symbol_pairs(msg).view(np.complex64)[:, 0]


def pbch_dmrs(msg: PbchMessage) -> np.ndarray:
    """(144,) DM-RS QPSK pilots (TS 38.211 Section 7.4.1.4)."""
    i_ssb = msg.ssb_idx % (4 if msg.l_max == 4 else 8)
    i_bar = i_ssb + (4 if (msg.l_max == 4 and msg.half_radio_frame) else 0)
    cinit = ((1 << 11) * (i_bar + 1) * (msg.n_id // 4 + 1) + (1 << 6) * (i_bar + 1)
             + (msg.n_id % 4)) % (1 << 31)
    bits = prg_mod.gold_sequence_bits(cinit, 288).astype(np.float32)
    vals = (1 - 2 * bits) / np.sqrt(2)
    return (vals[0::2] + 1j * vals[1::2]).astype(np.complex64)


#: PBCH REs of the block in mapping order: symbols 1 and 3 whole, symbol 2
#: outside the SSS (subcarriers 0-47 and 192-239).
_PBCH_RES = [(1, k) for k in range(240)] + [(2, k) for k in range(48)] + \
    [(2, k) for k in range(192, 240)] + [(3, k) for k in range(240)]


@functools.lru_cache(maxsize=64)
def _ssb_cell_part(n_id: int, ssb_idx: int, half_radio_frame: bool, l_max: int,
                   beta_pss: float) -> tuple[np.ndarray, np.ndarray]:
    """What a block holds that depends on the cell alone: (the block, float32
    pairs (4, 240, 2), with the PSS, SSS and PBCH DM-RS in place and zeros on
    the PBCH data REs; the flat (symbol * 240 + subcarrier) index of those
    data REs in mapping order).  Callers copy the block before writing."""
    grid = np.zeros((SSB_NSYM, SSB_NSUBC), np.complex64)
    grid[0, 56:183] = pss_sequence(n_id % 3) * beta_pss
    grid[2, 56:183] = sss_sequence(n_id // 3, n_id % 3)
    sym, sub = np.asarray(_PBCH_RES).T
    is_dmrs = sub % 4 == n_id % 4
    grid[sym[is_dmrs], sub[is_dmrs]] = pbch_dmrs(PbchMessage(
        sfn=0, ssb_idx=ssb_idx, half_radio_frame=half_radio_frame, n_id=n_id, l_max=l_max))
    return np_to_pair(grid), sym[~is_dmrs] * SSB_NSUBC + sub[~is_dmrs]


def ssb_block_pairs(msg: PbchMessage, beta_pss: float = 1.0) -> np.ndarray:
    """`assemble_ssb`'s block as float32 pairs (4, 240, 2)."""
    part, data_re = _ssb_cell_part(msg.n_id, msg.ssb_idx, bool(msg.half_radio_frame),
                                   msg.l_max, beta_pss)
    block = part.copy()
    block.reshape(-1, 2)[data_re] = pbch_symbol_pairs(msg)
    return block


def assemble_ssb(msg: PbchMessage, beta_pss: float = 1.0) -> np.ndarray:
    """SS/PBCH block grid (4 symbols x 240 subcarriers), complex64.

    Layout per TS 38.211 Table 7.4.3.1-1: PSS at symbol 0 subc 56..183,
    SSS at symbol 2 same range, PBCH on symbols 1,3 (full 240) and symbol 2
    (subc 0..47 and 192..239), DM-RS every 4th subcarrier with offset
    v = N_id mod 4 within the PBCH REs.
    """
    return ssb_block_pairs(msg, beta_pss).view(np.complex64)[..., 0]
