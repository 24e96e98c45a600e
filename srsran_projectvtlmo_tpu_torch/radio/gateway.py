"""Baseband gateways: the radio boundary of the framework.

The reference drives UHD (USRP) hardware or a ZMQ virtual RF loopback
(reference: lib/radio/uhd, lib/radio/zmq); offline equivalents here are an
in-memory loopback (tests, UE<->gNB co-simulation) and raw float32 IQ file
sink/source (interleaved I/Q pairs, the same layout as the reference's
file_vector<cf_t> binary format, include/srsran/support/file_vector.h:48-73).
"""

from __future__ import annotations

from collections import deque
from pathlib import Path

import numpy as np


class LoopbackGateway:
    """In-memory sample FIFO: transmit() pushes, receive() pops (per port)."""

    def __init__(self, nof_ports: int = 1):
        self.nof_ports = nof_ports
        self._fifo: deque[np.ndarray] = deque()

    def transmit(self, samples_pair: np.ndarray) -> None:
        self._fifo.append(np.asarray(samples_pair, np.float32))

    def receive(self, nof_samples: int) -> np.ndarray:
        """Returns (nof_ports, nof_samples, 2); zero-fills on underflow."""
        chunks = []
        need = nof_samples
        while need > 0 and self._fifo:
            head = self._fifo.popleft()
            if head.ndim == 2:
                head = head[None]
            take = min(need, head.shape[1])
            chunks.append(head[:, :take])
            if take < head.shape[1]:
                self._fifo.appendleft(head[:, take:])
            need -= take
        if need > 0:
            chunks.append(np.zeros((self.nof_ports, need, 2), np.float32))
        out = np.concatenate(chunks, axis=1)
        if out.shape[0] != self.nof_ports:
            out = np.broadcast_to(out, (self.nof_ports,) + out.shape[1:])
        return out.astype(np.float32)


class FileIqSink:
    """Writes interleaved complex float32 samples (file_vector<cf_t> layout)."""

    def __init__(self, path: str | Path):
        self._f = open(path, "wb")

    def transmit(self, samples_pair: np.ndarray) -> None:
        np.asarray(samples_pair, np.float32).tofile(self._f)

    def close(self) -> None:
        self._f.close()


class FileIqSource:
    """Reads interleaved complex float32 samples."""

    def __init__(self, path: str | Path, nof_ports: int = 1):
        self._data = np.fromfile(path, dtype=np.float32).reshape(-1, 2)
        self._pos = 0
        self.nof_ports = nof_ports

    def receive(self, nof_samples: int) -> np.ndarray:
        end = min(self._pos + nof_samples, len(self._data))
        chunk = self._data[self._pos:end]
        self._pos = end
        if len(chunk) < nof_samples:
            chunk = np.concatenate(
                [chunk, np.zeros((nof_samples - len(chunk), 2), np.float32)]
            )
        return np.broadcast_to(chunk[None], (self.nof_ports,) + chunk.shape).astype(np.float32)
