"""Gold-sequence pseudo-random generator, TS 38.211 Section 5.2.1.

c(n) = x1(n + Nc) xor x2(n + Nc), Nc = 1600, with the 31-bit LFSRs
  x1(n+31) = x1(n+3) + x1(n)                     x1 init = 0...01
  x2(n+31) = x2(n+3) + x2(n+2) + x2(n+1) + x2(n) x2 init = bits of c_init

The reference advances LFSR state sequentially with SIMD unrolls
(reference: lib/phy/upper/sequence_generators/pseudo_random_generator_impl.cpp).
The TPU-native formulation exploits linearity over GF(2): x2 with init c_init is
the XOR of basis streams x2^{(j)} (init = e_j) over the set bits of c_init, and
x1 does not depend on c_init at all.  We precompute, once per process,

    X1[n]       for n in [0, MAX_LEN)            (after the Nc offset)
    B[j][n] = x2^{(j)}(n + Nc)   j = 0..30

packed LSB-first into uint32 words.  Generating any sequence is then <= 31 XORs
of packed words - vectorized on host (numpy) or on device (jnp int32 ops), no
sequential scan anywhere.

Sequence lengths are capped by MAX_LEN (default 2^21 bits); the table grows on
demand in powers of two.

The port's own copy of `srsran_projectvtlmo_tpu.ops.prg`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import numpy as np

NC = 1600

_TAPS_X1 = (0, 3)
_TAPS_X2 = (0, 1, 2, 3)

# Module-level cache: number of valid bits and the (32, nwords) packed table.
# Row 0..30 = x2 basis streams, row 31 = x1 stream.
_table_bits = 0
_table: np.ndarray | None = None


def _extend_streams(streams: np.ndarray, taps: tuple[int, ...], total: int) -> np.ndarray:
    """Extend LFSR output streams (n_streams, >=31 valid bits) to `total` bits.

    Uses the GF(2) Frobenius identity: x^31 + sum x^t  ==>  for any power-of-two
    e, s[k] = XOR_t s[k - (31 - t) * e] with taps shifted by e, which lets the
    valid prefix nearly double per vectorized XOR pass.
    """
    n_streams, valid = streams.shape[0], 31
    out = np.zeros((n_streams, total), dtype=np.uint8)
    out[:, :31] = streams[:, :31]
    while valid < total:
        e = 1
        while 31 * (e << 1) <= valid:
            e <<= 1
        # Recurrence distances are (31 - t) * e per tap t; outputs k may only read
        # already-valid inputs, so the chunk is capped by the smallest distance.
        chunk = min((31 - max(taps)) * e, total - valid)
        lo, hi = valid, valid + chunk
        acc = np.zeros((n_streams, chunk), dtype=np.uint8)
        for t in taps:
            d = (31 - t) * e
            acc ^= out[:, lo - d:hi - d]
        out[:, lo:hi] = acc
        valid = hi
    return out


def _build_table(nof_bits: int) -> np.ndarray:
    total = nof_bits + NC
    # x2 basis streams: 31 impulses; x1 stream: init bit0 = 1.
    x2_init = np.eye(31, dtype=np.uint8)
    x2 = _extend_streams(x2_init, _TAPS_X2, total)
    x1_init = np.zeros((1, 31), dtype=np.uint8)
    x1_init[0, 0] = 1
    x1 = _extend_streams(x1_init, _TAPS_X1, total)
    rows = np.concatenate([x2, x1], axis=0)[:, NC:]
    # Pack LSB-first into uint32 words.
    bits = rows
    pad = (-bits.shape[1]) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros((32, pad), dtype=np.uint8)], axis=1)
    words = np.packbits(bits.reshape(32, -1, 32), axis=-1, bitorder="little").view(np.uint32)
    return words.reshape(32, -1)


def _ensure(nof_bits: int) -> np.ndarray:
    global _table_bits, _table
    if nof_bits > _table_bits:
        size = 1 << max(21, int(np.ceil(np.log2(max(nof_bits, 2)))))
        _table = _build_table(size)
        _table_bits = size
    return _table


def gold_table(nof_bits: int) -> np.ndarray:
    """Packed (32, nwords) uint32 basis table covering at least `nof_bits` bits."""
    return _ensure(nof_bits)


def gold_sequence_packed(c_init: int, nof_bits: int) -> np.ndarray:
    """Gold sequence as packed LSB-first uint32 words (host)."""
    table = _ensure(nof_bits)
    nwords = (nof_bits + 31) // 32
    acc = table[31, :nwords].copy()  # x1 contribution
    for j in range(31):
        if (c_init >> j) & 1:
            acc ^= table[j, :nwords]
    return acc


def gold_sequence_bits(c_init: int, nof_bits: int) -> np.ndarray:
    """Gold sequence as uint8 0/1 array (host)."""
    words = gold_sequence_packed(c_init, nof_bits)
    bits = np.unpackbits(words[:, None].view(np.uint8), axis=1, bitorder="little")
    return bits.reshape(-1)[:nof_bits]


def gold_sequence_signs(c_init: int, nof_bits: int) -> np.ndarray:
    """(-1)^c(n) as int8: +1 for bit 0, -1 for bit 1 (descrambling factor)."""
    return (1 - 2 * gold_sequence_bits(c_init, nof_bits).astype(np.int8)).astype(np.int8)
