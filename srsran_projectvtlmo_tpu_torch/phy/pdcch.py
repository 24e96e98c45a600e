"""PDCCH encoding/modulation and blind decoding (TS 38.212 Section 7.3,
TS 38.211 Section 7.3.2); port of `srsran_projectvtlmo_tpu.phy.pdcch`,
bit-exact with it.

Tx (host): DCI payload -> CRC24C over a 24-ones prefix, RNTI-masked parity ->
input interleaver -> polar (n_max = 9, no channel interleaver) -> rate match
-> scramble -> QPSK; the DL slot adds the symbols and their DM-RS at the
candidate's REs on the device.  Rx (`pdcch_blind_decode`, on the device of
its input): demap -> descramble -> rate dematch -> SC decode -> deinterleave
-> CRC check with RNTI unmasking.
reference: lib/phy/upper/channel_processors/pdcch_encoder_impl.cpp:33-98,
pdcch_modulator_impl.cpp, pdcch_processor_impl.cpp.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import prg as prg_mod
from ..ops.crc import crc_device, crc_host
from ..ops.demodulation import soft_demap
from ..ops.modulation import modulate_np
from ..ops.polar import PolarCode, polar_allocate, polar_deallocate, polar_decode, polar_encode
from ..ops.polar import rate_matching as polar_rm
from ..ops.polar.interleave import deinterleave, interleave
from ..ran.modulation import Modulation
from ..utils.tables import on_device

CRC_LEN = 24
RNTI_LEN = 16

#: REs per CCE: 6 REGs x 12 subcarriers, 3 of 12 are DM-RS -> 54 data REs.
RE_PER_CCE = 54
DMRS_PER_CCE = 18


def _polar_code(k: int, e: int) -> PolarCode:
    return PolarCode(K=k, E=e, n_max=9, ibil=False)


def _rnti_bits(rnti: int) -> np.ndarray:
    return np.asarray([(rnti >> (RNTI_LEN - 1 - i)) & 1 for i in range(RNTI_LEN)], np.uint8)


def pdcch_encode(dci_bits: np.ndarray, rnti: int, e: int) -> np.ndarray:
    """Encode one DCI payload to E rate-matched bits (host)."""
    a = np.asarray(dci_bits, dtype=np.uint8)
    k = len(a) + CRC_LEN
    code = _polar_code(k, e)
    # CRC24C over [1]*24 + payload; parity's last 16 bits masked with the RNTI.
    crc = crc_host(np.concatenate([np.ones(CRC_LEN, np.uint8), a]), "CRC24C")
    crc[-RNTI_LEN:] ^= _rnti_bits(rnti)
    c = np.concatenate([a, crc])
    u = polar_allocate(interleave(torch.as_tensor(c[None]), k), code)
    return polar_rm.rate_match(polar_encode(u, code.n), code)[0].numpy()


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


def pdcch_modulate(cfg: PdcchCandidateConfig, dci_bits: np.ndarray) -> np.ndarray:
    """DCI -> complex data symbols (aggregation_level * 54,) complex64."""
    coded = pdcch_encode(dci_bits, cfg.rnti, cfg.e)
    seq = prg_mod.gold_sequence_bits(pdcch_scrambling_cinit(cfg.n_id, cfg.n_rnti), cfg.e)
    return modulate_np(coded ^ seq, Modulation.QPSK)


def pdcch_dmrs_values(slot: int, start_symbol: int, duration: int,
                      prbs, n_id: int) -> np.ndarray:
    """DM-RS pilot values for a candidate, ordered (symbol, prb, k in {1,5,9}).

    The Gold sequence is CRB-indexed (3 pilots per PRB from reference point 0)
    with per-symbol c_init (TS 38.211 Section 7.4.1.3).
    """
    vals = []
    mmax = (max(prbs) + 1) * 3
    for sym in range(start_symbol, start_symbol + duration):
        cinit = ((1 << 17) * (14 * slot + sym + 1) * (2 * n_id + 1)
                 + 2 * n_id) % (1 << 31)
        bits = prg_mod.gold_sequence_bits(cinit, 2 * mmax).astype(np.float32)
        v = (1.0 - 2.0 * bits) / np.sqrt(2.0)
        pil = (v[0::2] + 1j * v[1::2]).astype(np.complex64)
        for prb in prbs:
            vals.extend(pil[3 * prb:3 * prb + 3])
    return np.asarray(vals, np.complex64)


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
