"""DCI channel coding, TS 38.212 Section 7.3: CRC24C over a 24-ones prefix
with the RNTI-masked parity, the input interleaver, polar (n_max = 9, no
channel interleaver) and rate matching (the coding part of a frozen copy of
the port's `phy/pdcch`, itself a port of `srsran_projectvtlmo_tpu.phy.pdcch`).
reference: lib/phy/upper/channel_processors/pdcch_encoder_impl.cpp:33-98.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.crc import crc_host
from ..ops.polar import PolarCode, polar_allocate, polar_encode
from ..ops.polar import rate_matching as polar_rm
from ..ops.polar.interleave import interleave

CRC_LEN = 24
RNTI_LEN = 16


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
