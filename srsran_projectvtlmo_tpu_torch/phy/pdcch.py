"""PDCCH encoding/modulation and blind decoding (TS 38.212 Section 7.3,
TS 38.211 Section 7.3.2); port of `srsran_projectvtlmo_tpu.phy.pdcch`,
bit-exact with it.

Tx (host): DCI payload -> CRC24C over a 24-ones prefix, RNTI-masked parity ->
input interleaver -> polar (n_max = 9, no channel interleaver) -> rate match
-> scramble -> QPSK; the DL slot adds the symbols and their DM-RS at the
candidate's REs on the device.  The chain up to the rate-matched bits is
affine over GF(2) in [DCI bits, RNTI bits], so it runs once per input bit of
each (DCI size, E) to build an encode table (`ops.gf2`), and every
encode is a lookup in that table.  Rx (`pdcch_blind_decode`, on the device of
its input): demap -> descramble -> rate dematch -> SC decode -> deinterleave
-> CRC check with RNTI unmasking.
reference: lib/phy/upper/channel_processors/pdcch_encoder_impl.cpp:33-98,
pdcch_modulator_impl.cpp, pdcch_processor_impl.cpp.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import gf2
from ..ops import prg as prg_mod
from ..ops.crc import crc_device, crc_host
from ..ops.demodulation import soft_demap
from ..ops.modulation import constellation
from ..ops.polar import PolarCode, polar_allocate, polar_deallocate, polar_decode, polar_encode
from ..ops.polar import rate_matching as polar_rm
from ..ops.polar.interleave import deinterleave, interleave
from ..ran.modulation import Modulation
from ..utils import tracing
from ..utils.cplx import np_to_pair
from ..utils.tables import on_device

CRC_LEN = 24
RNTI_LEN = 16

#: REs per CCE: 6 REGs x 12 subcarriers, 3 of 12 are DM-RS -> 54 data REs.
RE_PER_CCE = 54
DMRS_PER_CCE = 18


def _polar_code(k: int, e: int) -> PolarCode:
    return PolarCode(K=k, E=e, n_max=9, ibil=False)


_RNTI_SHIFTS = np.arange(RNTI_LEN - 1, -1, -1)


def _rnti_bits(rnti: int) -> np.ndarray:
    return ((rnti >> _RNTI_SHIFTS) & 1).astype(np.uint8)


def _encode_chain(bits: np.ndarray, nof_dci_bits: int, e: int) -> np.ndarray:
    """The encoder's bit chain: [DCI bits, RNTI bits] -> E rate-matched bits
    (what the encode tables are built from, and what the tests hold them
    against)."""
    a, rnti_bits = bits[:nof_dci_bits], bits[nof_dci_bits:]
    k = nof_dci_bits + CRC_LEN
    code = _polar_code(k, e)
    # CRC24C over [1]*24 + payload; parity's last 16 bits masked with the RNTI.
    crc = crc_host(np.concatenate([np.ones(CRC_LEN, np.uint8), a]), "CRC24C")
    crc[-RNTI_LEN:] ^= rnti_bits
    c = np.concatenate([a, crc])
    u = polar_allocate(interleave(torch.as_tensor(c[None]), k), code)
    return polar_rm.rate_match(polar_encode(u, code.n), code)[0].numpy()


def _build_table(nof_dci_bits: int, e: int) -> gf2.EncodeTable:
    return gf2.build_table(lambda bits: _encode_chain(bits, nof_dci_bits, e),
                           nof_dci_bits + RNTI_LEN)


#: Encode tables per (DCI size, E).
TABLES = gf2.TableCache(_build_table)


def _encode_packed(dci_bits: np.ndarray, rnti: int, e: int) -> np.ndarray:
    """`pdcch_encode`'s bits packed (`ops.gf2` words); counts
    `dl_encodes`, and `dl_table_encodes` where the table was already built."""
    a = np.asarray(dci_bits, dtype=np.uint8)
    table, built = TABLES.get(len(a), e)
    tracing.count("dl_encodes", 1)
    tracing.count("dl_table_encodes", int(built))
    return table.encode(np.concatenate([a, _rnti_bits(rnti)]))


def pdcch_encode(dci_bits: np.ndarray, rnti: int, e: int) -> np.ndarray:
    """Encode one DCI payload to E rate-matched bits (host)."""
    return gf2.unpack(_encode_packed(dci_bits, rnti, e), e)


def pdcch_scrambling_cinit(n_id: int, n_rnti: int) -> int:
    return ((n_rnti << 16) + n_id) % (1 << 31)


@dataclass(frozen=True)
class PdcchCandidateConfig:
    nof_dci_bits: int
    aggregation_level: int  # 1, 2, 4, 8, 16 CCEs
    rnti: int
    n_id: int = 0        # pdcch-DMRS-ScramblingID / scrambling id
    n_rnti: int = 0      # scrambling RNTI (UE-specific search space)

    @property
    def e(self) -> int:
        return self.aggregation_level * RE_PER_CCE * 2  # QPSK


#: QPSK's two float32 levels: the points are (l[b0], l[b1]), l the real parts
#: of the constellation's points 0 (b0 = 0) and 3 (b0 = 1).
QPSK_LEVELS = np_to_pair(constellation(Modulation.QPSK))[[0, 3], 0]


def qpsk_pairs(bits: np.ndarray) -> np.ndarray:
    """(2n,) bits -> (n, 2) float32 QPSK symbols, the pairs of `modulate_np`'s."""
    return QPSK_LEVELS[bits].reshape(-1, 2)


def pdcch_symbol_pairs(cfg: PdcchCandidateConfig, dci_bits: np.ndarray) -> np.ndarray:
    """DCI -> data symbols as float32 pairs (aggregation_level * 54, 2): the
    encoded words scrambled word for word with the packed Gold sequence."""
    coded = _encode_packed(dci_bits, cfg.rnti, cfg.e)
    seq = prg_mod.gold_sequence_packed(pdcch_scrambling_cinit(cfg.n_id, cfg.n_rnti), cfg.e)
    return qpsk_pairs(gf2.unpack(coded ^ seq, cfg.e))


def pdcch_modulate(cfg: PdcchCandidateConfig, dci_bits: np.ndarray) -> np.ndarray:
    """DCI -> complex data symbols (aggregation_level * 54,) complex64."""
    return pdcch_symbol_pairs(cfg, dci_bits).view(np.complex64)[:, 0]


#: The DM-RS's two levels, (1 - 2 c) / sqrt(2) in float32.
_DMRS_LEVELS = ((1.0 - 2.0 * np.arange(2, dtype=np.float32)) / np.sqrt(2.0)).astype(np.float32)


def pdcch_dmrs_index(duration: int, prbs) -> tuple[int, np.ndarray]:
    """(pilots per symbol, the flat (symbol, pilot) index of a candidate's
    DM-RS in value order): the Gold sequence is CRB-indexed, 3 pilots per
    PRB from reference point 0."""
    mmax = (max(prbs) + 1) * 3
    per_sym = (3 * np.asarray(prbs, np.int64)[:, None] + np.arange(3)).reshape(-1)
    return mmax, (np.arange(duration)[:, None] * mmax + per_sym).reshape(-1)


def pdcch_dmrs_pairs(slot: int, start_symbol: int, duration: int, mmax: int,
                     index: np.ndarray, n_id: int) -> np.ndarray:
    """DM-RS pilots of a candidate as float32 pairs, at `pdcch_dmrs_index`'s
    `index` over the per-symbol sequences (c_init per symbol, TS 38.211
    Section 7.4.1.3)."""
    bits = np.concatenate([
        prg_mod.gold_sequence_bits(((1 << 17) * (14 * slot + sym + 1) * (2 * n_id + 1)
                                    + 2 * n_id) % (1 << 31), 2 * mmax)
        for sym in range(start_symbol, start_symbol + duration)])
    return _DMRS_LEVELS[bits.reshape(-1, 2)[index]]


def pdcch_dmrs_values(slot: int, start_symbol: int, duration: int,
                      prbs, n_id: int) -> np.ndarray:
    """DM-RS pilot values for a candidate, ordered (symbol, prb, k in {1,5,9})."""
    mmax, index = pdcch_dmrs_index(duration, prbs)
    return pdcch_dmrs_pairs(slot, start_symbol, duration, mmax, index,
                            n_id).view(np.complex64)[:, 0]


def _descramble_signs(n_id: int, n_rnti: int, e: int) -> np.ndarray:
    return 1 - 2 * prg_mod.gold_sequence_bits(pdcch_scrambling_cinit(n_id, n_rnti),
                                              e).astype(np.int32)


def pdcch_blind_decode(rx_syms_pair: torch.Tensor, noise_var: torch.Tensor,
                       cfg: PdcchCandidateConfig):
    """Attempt decoding one candidate from (B, E/2, 2) equalized symbols.

    Returns (dci_bits (B, nof_dci_bits) uint8, crc_ok (B,) bool), on the
    device of the symbols.
    """
    dev = rx_syms_pair.device
    llr = soft_demap(rx_syms_pair, noise_var, Modulation.QPSK)  # (B, E)
    signs = on_device(_descramble_signs, cfg.n_id, cfg.n_rnti, cfg.e, device=dev)
    llr = torch.clamp(llr.to(torch.int32) * signs, -127, 127).to(torch.int8)

    k = cfg.nof_dci_bits + CRC_LEN
    code = _polar_code(k, cfg.e)
    u = polar_decode(polar_rm.rate_dematch(llr, code), code)
    c = deinterleave(polar_deallocate(u, code), k).to(torch.uint8)

    a = c[..., :cfg.nof_dci_bits]
    unmasked = c[..., cfg.nof_dci_bits:].clone()
    unmasked[..., -RNTI_LEN:] ^= on_device(_rnti_bits, cfg.rnti, device=dev)
    # Verify CRC24C over ones-prefix + payload.
    ones = torch.ones(a.shape[:-1] + (CRC_LEN,), dtype=torch.uint8, device=dev)
    expect = crc_device(torch.cat([ones, a], dim=-1), "CRC24C")
    return a, torch.all(expect == unmasked, dim=-1)
