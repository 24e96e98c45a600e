"""Encode tables: the DL encoders of `phy.pdcch` and `phy.pbch` as packed
rows over GF(2).

For a fixed code (K, E) the PDCCH and PBCH encoders (CRC, interleaver,
allocation, polar transform, rate matching) are affine over GF(2) in their
input bits, so a codeword is an offset XOR the rows of the set input bits.
A table is built once per shape by running the chain on the zero input and
on each unit input; an encode is then one XOR reduction over at most
`nof_inputs` packed rows instead of the chain's tensor stages.

Words are uint32, LSB-first (bit i in word i // 32 at bit i % 32), as
`ops.prg` packs its Gold table, so an encoded codeword XORs straight with a
packed scrambling sequence.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np


def pack(bits: np.ndarray) -> np.ndarray:
    """(..., n) 0/1 uint8 -> (..., ceil(n / 32)) uint32 words."""
    n = bits.shape[-1]
    pad = np.zeros(bits.shape[:-1] + (-n % 32,), np.uint8)
    octets = np.packbits(np.concatenate([bits.astype(np.uint8), pad], axis=-1), axis=-1,
                         bitorder="little")
    return np.ascontiguousarray(octets).view(np.uint32)


def unpack(words: np.ndarray, nof_bits: int) -> np.ndarray:
    """The first `nof_bits` bits of packed words, (nof_bits,) uint8."""
    return np.unpackbits(words.view(np.uint8), bitorder="little")[:nof_bits]


class EncodeTable(NamedTuple):
    """chain(x) = offset XOR the rows of x's set bits, as words."""
    offset: np.ndarray  # (W,) uint32
    rows: np.ndarray    # (nof_inputs, W) uint32

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """(nof_inputs,) 0/1 input -> the chain's output, (W,) uint32 words."""
        return self.offset ^ np.bitwise_xor.reduce(self.rows[bits.astype(bool)], axis=0)


def build_table(chain, nof_inputs: int) -> EncodeTable:
    """The table of `chain`, (nof_inputs,) uint8 -> (E,) uint8, which must be
    affine over GF(2): nof_inputs + 1 runs of the chain."""
    offset = chain(np.zeros(nof_inputs, np.uint8))
    rows = np.stack([chain(unit) ^ offset for unit in np.eye(nof_inputs, dtype=np.uint8)])
    return EncodeTable(pack(offset), pack(rows))


class TableCache:
    """`build(*key)` kept per key, which holds shapes only.  Safe from several
    threads: each key's table is built once, under the lock."""

    def __init__(self, build):
        self._build = build
        self._tables: dict = {}
        self._lock = threading.Lock()

    def get(self, *key) -> tuple[EncodeTable, bool]:
        """(the key's table, whether it was there before this call)."""
        table = self._tables.get(key)
        if table is not None:
            return table, True
        with self._lock:
            table = self._tables.get(key)
            if table is None:
                table = self._tables[key] = self._build(*key)
        return table, False

    def keys(self) -> list:
        return list(self._tables)
