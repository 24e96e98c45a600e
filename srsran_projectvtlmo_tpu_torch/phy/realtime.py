"""Lower-PHY realtime machinery: self-re-enqueueing DL/UL chains, bounded
slot-in-flight pipelining and the PRACH occasion-window state machine
(port of `srsran_projectvtlmo_tpu.phy.realtime`).

Mirrors the reference's baseband processor architecture
(reference: lib/phy/lower/lower_phy_baseband_processor.cpp:78-196: dl_process/
ul_process tasks re-enqueue themselves on dedicated executors with bounded
buffer queues and throttling; lib/phy/lower/processors/uplink/prach/
prach_processor_worker.h:48-102: wait -> collecting -> processing window
state machine).  Device work is dispatched asynchronously on the card's
stream, so the "slots in flight" window (max_proc_delay_slots) maps onto
queued device work whose results are only copied to the host when the
deadline accountant drains them.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .error_handler import UpperPhyErrorHandler


@dataclass
class _InFlight:
    slot: int
    submitted_at: float
    result: object  # un-synced device tensors / lazy container
    on_done: Callable | None


def _leaves(tree) -> list:
    """The leaves of nested dicts (in key order), lists and tuples; None is
    an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


class SlotPipeline:
    """Bounded window of asynchronously dispatched slot results.

    `submit` enqueues the (already dispatched, unsynced) device result; when
    the window exceeds `max_proc_delay_slots`, the oldest entry is drained
    (copied to the host + surrendered to its callback).  Deadline accounting
    runs through the error handler: a slot whose sync completes later than
    slot_duration * (max_proc_delay_slots + 1) after submission is late
    (reference: du_low max_proc_delay semantics, du_low_config.h:82-104).
    """

    def __init__(self, error_handler: UpperPhyErrorHandler,
                 max_proc_delay_slots: int = 2, sync=None):
        self.error_handler = error_handler
        self.max_proc_delay_slots = max_proc_delay_slots
        self._inflight: list[_InFlight] = []
        # Result synchronizer (pluggable for tests): forces device completion.
        self._sync = sync or self._default_sync

    @staticmethod
    def _default_sync(result) -> list[np.ndarray]:
        """Every tensor of `result` copied to the host: the copy waits for the
        device work that produces it.  numpy has no bfloat16, so a bfloat16
        tensor (the DL slot's grid) comes back as float32, which holds its
        values exactly."""
        return [(x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
                if isinstance(x, torch.Tensor) else np.asarray(x) for x in _leaves(result)]

    def submit(self, slot: int, result, on_done: Callable | None = None) -> None:
        self._inflight.append(_InFlight(slot, time.perf_counter(), result, on_done))
        while len(self._inflight) > self.max_proc_delay_slots:
            self._drain_one()

    def _drain_one(self) -> None:
        entry = self._inflight.pop(0)
        synced = self._sync(entry.result)
        budget = self.error_handler.slot_duration_s * (self.max_proc_delay_slots + 1)
        latency = time.perf_counter() - entry.submitted_at
        if latency > budget:
            self.error_handler.stats.late_ul += 1
            self.error_handler._on_error("late_pipeline", entry.slot, latency)
        if entry.on_done is not None:
            entry.on_done(entry.slot, synced)

    def flush(self) -> None:
        while self._inflight:
            self._drain_one()

    @property
    def nof_in_flight(self) -> int:
        return len(self._inflight)


class BasebandChain:
    """One self-re-enqueueing processing chain (DL or UL) on its own worker.

    The reference seeds N initial tasks that each re-enqueue themselves after
    processing one buffer (lower_phy_baseband_processor.cpp:78-103 start():
    queue depth = nof buffers, giving bounded lookahead/throttling).  Here a
    dedicated thread drains a bounded request queue; producers block when the
    chain is `queue_depth` slots ahead -- the same throttling contract.
    """

    def __init__(self, name: str, process: Callable, queue_depth: int = 4):
        self.name = name
        self._process = process
        self._requests: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._results: queue.Queue = queue.Queue()
        self._quit = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = False

    def start(self) -> None:
        if not self._started:
            self._thread.start()
            self._started = True

    def stop(self) -> None:
        self._quit.set()
        # Unblock the worker if it is waiting for a request.
        try:
            self._requests.put_nowait(None)
        except queue.Full:
            pass
        if self._started:
            self._thread.join(timeout=5.0)

    def enqueue(self, request, timeout: float | None = None) -> None:
        """Blocks when the chain is queue_depth slots ahead (throttling)."""
        self._requests.put(request, timeout=timeout)

    def results(self, max_items: int | None = None) -> list:
        out = []
        while max_items is None or len(out) < max_items:
            try:
                out.append(self._results.get_nowait())
            except queue.Empty:
                break
        return out

    def wait_result(self, timeout: float | None = None):
        return self._results.get(timeout=timeout)

    def _run(self) -> None:
        while not self._quit.is_set():
            req = self._requests.get()
            if req is None or self._quit.is_set():
                break
            try:
                self._results.put((req, self._process(req)))
            except Exception as exc:  # surfaced to the consumer
                self._results.put((req, exc))


class LowerPhyRealtime:
    """DL + UL chains with bounded queues, driving an upper PHY and a
    baseband gateway -- the du-low-equivalent realtime loop.  The DL chain
    takes (DlTtiRequest, TxDataRequest) and hands the slot's samples to the
    gateway; the UL chain takes (UlTtiRequest, nof_samples, PRACH samples)
    and returns the indications.  A chain returns an exception raised by
    the upper PHY as that request's result."""

    def __init__(self, upper_phy, gateway, error_handler: UpperPhyErrorHandler,
                 queue_depth: int = 4):
        self.upper = upper_phy
        self.gateway = gateway
        self.error_handler = error_handler
        self.dl = BasebandChain("lower-dl", self._dl_process, queue_depth)
        self.ul = BasebandChain("lower-ul", self._ul_process, queue_depth)

    def start(self) -> None:
        self.dl.start()
        self.ul.start()

    def stop(self) -> None:
        self.dl.stop()
        self.ul.stop()

    def _dl_process(self, req):
        slot_t0 = time.perf_counter()
        request, tx_data = req
        grid, samples = self.upper.process_dl_slot(request, tx_data)
        self.gateway.transmit(samples)
        self.error_handler.check_dl_deadline(request.slot, slot_t0)
        return samples.shape

    def _ul_process(self, req):
        slot_t0 = time.perf_counter()
        request, nof_samples, prach = req
        samples = self.gateway.receive(nof_samples)
        inds = self.upper.process_ul_slot(request, samples, prach)
        self.error_handler.check_ul_deadline(request.slot, slot_t0)
        return inds


class PrachOccasionCollector:
    """PRACH window state machine: wait -> collecting -> ready.

    Symbol callbacks stream baseband/occasion samples; a configured occasion
    window [start_symbol, start_symbol + nof_symbols) is accumulated and
    surrendered as one buffer when complete
    (reference: prach_processor_worker.h:48-102).
    """

    WAIT, COLLECTING, READY = range(3)

    def __init__(self):
        self.state = self.WAIT
        self._cfg = None
        self._parts: list[np.ndarray] = []

    def configure(self, slot: int, start_symbol: int, nof_symbols: int) -> None:
        self._cfg = (slot, start_symbol, nof_symbols)
        self._parts = []
        self.state = self.WAIT

    def on_symbol(self, slot: int, symbol: int, samples: np.ndarray):
        """Feed one symbol's occasion samples; returns the full window
        (nof_symbols, ...) when it completes, else None."""
        if self._cfg is None or slot != self._cfg[0]:
            return None
        start, n = self._cfg[1], self._cfg[2]
        if symbol < start or symbol >= start + n:
            return None
        if self.state == self.WAIT:
            self.state = self.COLLECTING
        self._parts.append(np.asarray(samples))
        if len(self._parts) == n:
            self.state = self.READY
            window = np.stack(self._parts)
            self._cfg = None
            self._parts = []
            return window
        return None
