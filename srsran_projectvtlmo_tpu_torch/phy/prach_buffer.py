"""PRACH buffer + pool: per-occasion frequency-domain capture buffers
(port of `srsran_projectvtlmo_tpu.phy.prach_buffer`).

Mirrors the reference's prach_buffer abstraction -- a tensor indexed by
(fd occasion, td occasion/symbol, port) holding the demodulated PRACH
sequence samples, plus a pool that hands out buffers per occasion and
reclaims them after detection
(reference: lib/phy/support/prach_buffer_impl.h,
lib/phy/support/prach_buffer_pool_impl.cpp).

Storage is host numpy in the real-pair (..., 2) convention; the detector
copies one occasion to the device.  The pool is thread-safe: the lower-PHY
occasion collector fills buffers from symbol callbacks while the upper-PHY
detector drains completed ones, so acquisition runs under a
sanitizer-tracked lock (utils/sanitizer.TrackedLock).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.sanitizer import TrackedLock


@dataclass(frozen=True)
class PrachBufferFormat:
    """Static geometry of one PRACH occasion buffer."""

    sequence_length: int  # 839 (long) or 139 (short)
    nof_symbols: int = 1  # td repetitions within the occasion
    nof_fd_occasions: int = 1
    nof_ports: int = 1


class PrachBuffer:
    """One occasion's frequency-domain samples:
    (nof_fd_occasions, nof_symbols, nof_ports, L, 2) float32."""

    def __init__(self, fmt: PrachBufferFormat, index: int):
        self.fmt = fmt
        self.index = index
        self.slot: int | None = None
        self._data = np.zeros(
            (fmt.nof_fd_occasions, fmt.nof_symbols, fmt.nof_ports,
             fmt.sequence_length, 2), np.float32)
        self._filled = np.zeros(
            (fmt.nof_fd_occasions, fmt.nof_symbols, fmt.nof_ports), bool)

    def set_symbol(self, fd_occasion: int, symbol: int,
                   samples: np.ndarray, port: int | None = None) -> None:
        """Store one symbol's samples.

        With `port=None`, samples must cover every port: (nof_ports, L, 2)
        (or (L, 2) for a single-port format).  With `port=k`, samples are one
        port's (L, 2) window (the per-port lower-PHY collector path) and only
        that port's fill flag advances.  Shape mismatches raise: broadcasting
        one port's data onto all ports would inflate the detector's
        non-coherent combining metric.
        """
        samples = np.asarray(samples, np.float32)
        if port is not None:
            expect = (self.fmt.sequence_length, 2)
            if samples.shape != expect:
                raise ValueError(
                    f"PRACH symbol samples shape {samples.shape} != {expect}")
            self._data[fd_occasion, symbol, port] = samples
            self._filled[fd_occasion, symbol, port] = True
            return
        if samples.ndim == 2:
            samples = samples[None]
        expect = (self.fmt.nof_ports, self.fmt.sequence_length, 2)
        if samples.shape != expect:
            raise ValueError(
                f"PRACH symbol samples shape {samples.shape} != {expect}")
        self._data[fd_occasion, symbol] = samples
        self._filled[fd_occasion, symbol] = True

    def get_symbol(self, fd_occasion: int, symbol: int) -> np.ndarray:
        return self._data[fd_occasion, symbol]

    def occasion(self, fd_occasion: int = 0) -> np.ndarray:
        """(nof_symbols, nof_ports, L, 2) view for the detector."""
        return self._data[fd_occasion]

    @property
    def full(self) -> bool:
        return bool(self._filled.all())

    def reset(self) -> None:
        self._data.fill(0.0)
        self._filled.fill(False)
        self.slot = None


class PrachBufferPool:
    """Fixed-size pool of PRACH buffers with reserve/release semantics.

    `reserve(slot)` returns a zeroed buffer (None when exhausted -- the
    caller accounts a late/dropped occasion, matching the reference's pool
    behavior of failing the capture request rather than blocking).
    """

    def __init__(self, fmt: PrachBufferFormat, nof_buffers: int = 4):
        self.fmt = fmt
        self._lock = TrackedLock("prach_buffer_pool")
        self._buffers = [PrachBuffer(fmt, i) for i in range(nof_buffers)]
        self._free = list(range(nof_buffers))

    def reserve(self, slot: int) -> PrachBuffer | None:
        with self._lock:
            if not self._free:
                return None
            buf = self._buffers[self._free.pop()]
        buf.reset()
        buf.slot = slot
        return buf

    def release(self, buf: PrachBuffer) -> None:
        with self._lock:
            if buf.index in self._free:
                raise ValueError(f"double release of PRACH buffer {buf.index}")
            self._free.append(buf.index)

    @property
    def nof_free(self) -> int:
        with self._lock:
            return len(self._free)
