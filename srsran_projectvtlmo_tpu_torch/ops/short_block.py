"""Short-block codes for UCI payloads of 1-11 bits, TS 38.212 Section 5.3.3
(port of `srsran_projectvtlmo_tpu.ops.short_block`).

Encoding: K=1 repetition (with modulation placeholders), K=2 simplex, K=3..11
Reed-Muller (32, K) over the standard basis (Table 5.3.3.3-1).  Detection is
brute-force maximum likelihood: correlate the received soft bits against all
2^K codewords (one matmul) and take the first maximum
(reference: lib/phy/upper/channel_coding/short/short_block_detector_impl.h:33-42,
short_block_encoder_impl.cpp:35-115).

Placeholder bits (x = PLACEHOLDER_ONE, y = PLACEHOLDER_REPEAT) are encoded as
bit value 1 / repeat-previous on Tx.  `BASIS`, `encode_host` and `_codebook`
are host copies of the JAX module's, held equal by tests/test_torch_polar_uci.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tables import on_device

#: TS 38.212 Table 5.3.3.3-1 Reed-Muller basis (11 rows x 32 columns).
BASIS = np.array([
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 0],
    [0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 1, 0],
    [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0],
    [0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0],
    [0, 0, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0],
    [0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0],
    [0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 0],
], dtype=np.uint8)


def encode_host(msg: np.ndarray, out_len: int, bits_per_symbol: int = 1) -> np.ndarray:
    """Encode K=1..11 bits to `out_len` bits (rate matching by cyclic repetition).

    Placeholders: for K<=2, 'x' bits are set to 1 and 'y' bits repeat the
    previous bit (TS 38.212 placeholders for modulation).
    """
    k = len(msg)
    if k == 1:
        base = np.ones(max(bits_per_symbol, 1), dtype=np.uint8)
        base[0] = msg[0]
        if len(base) > 1:
            base[1] = msg[0]  # y placeholder repeats c0
    elif k == 2:
        c0, c1 = int(msg[0]), int(msg[1])
        c2 = c0 ^ c1
        step = max(bits_per_symbol, 1)
        base = np.ones(3 * step, dtype=np.uint8)  # placeholders 'x' -> 1
        base[0] = c0
        base[1] = c1
        if step == 1:
            base[2] = c2
        else:
            base[step] = c2
            base[step + 1] = c0
            base[2 * step] = c1
            base[2 * step + 1] = c2
    else:
        base = (msg @ BASIS[:k]) % 2
    reps = -(-out_len // len(base))
    return np.tile(base, reps)[:out_len].astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _codebook(k: int, out_len: int, bits_per_symbol: int) -> np.ndarray:
    """(2^K, out_len) float32 antipodal codebook (+1 = bit 0)."""
    words = []
    for m in range(1 << k):
        bits = np.array([(m >> (k - 1 - i)) & 1 for i in range(k)], dtype=np.uint8)
        cw = encode_host(bits, out_len, bits_per_symbol)
        words.append(1.0 - 2.0 * cw.astype(np.float32))
    return np.stack(words)


def _codebook_t64(k: int, out_len: int, bits_per_symbol: int) -> np.ndarray:
    return np.ascontiguousarray(_codebook(k, out_len, bits_per_symbol).T.astype(np.float64))


def _weights(k: int) -> np.ndarray:
    return np.asarray([1 << (k - 1 - i) for i in range(k)], np.int64)


def detect(llrs: torch.Tensor, k: int, bits_per_symbol: int = 1):
    """ML detection of a K-bit short-block message from (B, E) soft bits.

    Returns (bits (B, K) uint8, metric (B,) float32 normalized correlation).
    The correlations of integer LLRs against +/-1 are integers, computed
    exactly: float64 products and sums (no TF32 mode applies to float64),
    then float32 as in JAX.  argmax takes the first maximum, as JAX's.
    """
    e = llrs.shape[-1]
    dev = llrs.device
    x = llrs.to(torch.float64)
    corr = (x @ on_device(_codebook_t64, k, e, bits_per_symbol, device=dev)).to(torch.float32)
    best = torch.argmax(corr, dim=-1)
    energy = torch.sqrt((x * x).sum(dim=-1).to(torch.float32) * float(e)) + 1e-9
    metric = corr.gather(-1, best[..., None])[..., 0] / energy
    bits = ((best[..., None] & on_device(_weights, k, device=dev)) > 0).to(torch.uint8)
    return bits, metric
