"""Streaming rx-symbol handling: dispatch allocations when their last symbol lands.

The reference's upper PHY receives the UL resource grid symbol by symbol from
the lower PHY and dispatches each pending PDU once its final OFDM symbol has
arrived (reference: lib/phy/upper/upper_phy_rx_symbol_handler_impl.cpp:48-131,
uplink_slot_pdu_repository).  Here the repository tracks pending UL PDUs per
slot; symbols accumulate into a host-side grid buffer and ready PDUs are
returned to the caller (who runs them through UpperPhy.process_ul_slot or the
per-PDU processors).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PendingPdu:
    pdu: object
    last_symbol: int


class UplinkSlotPduRepository:
    """Pending UL PDUs keyed by slot (reference: uplink_slot_pdu_repository)."""

    def __init__(self):
        self._pending: dict[int, list[PendingPdu]] = defaultdict(list)

    def add(self, slot: int, pdu) -> None:
        last = pdu.start_symbol + pdu.nof_symbols - 1
        self._pending[slot].append(PendingPdu(pdu, last))

    def pop_ready(self, slot: int, symbol: int) -> list:
        ready = [p.pdu for p in self._pending[slot] if p.last_symbol == symbol]
        self._pending[slot] = [p for p in self._pending[slot] if p.last_symbol != symbol]
        return ready

    def clear_slot(self, slot: int) -> list:
        return [p.pdu for p in self._pending.pop(slot, [])]

    def nof_pending(self, slot: int) -> int:
        return len(self._pending.get(slot, []))


class RxSymbolHandler:
    """Accumulates per-symbol rx data and surfaces PDUs whose window completed."""

    def __init__(self, nof_rx_ports: int, nof_subc: int, nof_symbols: int = 14):
        self.repo = UplinkSlotPduRepository()
        self._shape = (nof_rx_ports, nof_symbols, nof_subc)
        self._grids: dict[int, np.ndarray] = {}
        self._seen: dict[int, set[int]] = defaultdict(set)

    def handle_rx_symbol(self, slot: int, symbol: int, symbol_data: np.ndarray) -> list:
        """symbol_data (nof_rx_ports, nof_subc) complex -> list of ready PDUs."""
        grid = self._grids.setdefault(slot, np.zeros(self._shape, np.complex64))
        grid[:, symbol, :] = symbol_data
        self._seen[slot].add(symbol)
        return self.repo.pop_ready(slot, symbol)

    def grid(self, slot: int) -> np.ndarray:
        return self._grids[slot]

    def release_slot(self, slot: int) -> None:
        self._grids.pop(slot, None)
        self._seen.pop(slot, None)


class RxSymbolFileDumper:
    """Decorator over `RxSymbolHandler` that appends each completed slot's
    UL resource grid to a binary capture file for field debugging
    (reference: upper_phy_rx_symbol_handler_printer_decorator.h, YAML
    `phy_rx_symbols_filename`).

    File format matches the reference: per slot, ports [start, stop) x 14
    symbols x nof_subc complex64 values, written back to back.  Writes run
    on a background thread so the hot path only enqueues.
    """

    def __init__(self, inner: RxSymbolHandler, filename: str,
                 ports: tuple[int, int] | None = None,
                 last_symbol: int = 13):
        import queue
        import threading

        self.inner = inner
        self.repo = inner.repo
        self._ports = ports
        self._last_symbol = last_symbol
        self._file = open(filename, "wb")
        self._q: "queue.Queue[np.ndarray | None]" = queue.Queue(maxsize=64)
        self.nof_dropped_writes = 0
        self.nof_slots_written = 0

        def _writer():
            while True:
                item = self._q.get()
                if item is None:
                    break
                self._file.write(item.tobytes())
                self._file.flush()

        self._thread = threading.Thread(target=_writer, daemon=True,
                                        name="rx_symb_dump")
        self._thread.start()

    def handle_rx_symbol(self, slot: int, symbol: int,
                         symbol_data: np.ndarray) -> list:
        ready = self.inner.handle_rx_symbol(slot, symbol, symbol_data)
        if symbol == self._last_symbol:
            grid = self.inner.grid(slot)
            if self._ports is not None:
                grid = grid[self._ports[0]:self._ports[1]]
            try:
                self._q.put_nowait(np.ascontiguousarray(grid))
                self.nof_slots_written += 1
            except Exception:
                # Queue full: drop rather than stall the receive path
                # (the reference logs and skips likewise).
                self.nof_dropped_writes += 1
        return ready

    def grid(self, slot: int) -> np.ndarray:
        return self.inner.grid(slot)

    def release_slot(self, slot: int) -> None:
        self.inner.release_slot(slot)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)
        self._file.close()
