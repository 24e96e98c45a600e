"""HARQ soft-buffer pool: a device-resident rx_buffer arena
(port of `srsran_projectvtlmo_tpu.phy.harq`).

The reference keeps persistent soft-bit + CB-CRC buffers keyed by
(RNTI, HARQ-id) with slot-based reservation/expiry
(reference: include/srsran/phy/upper/rx_buffer_pool.h:40-106,
lib/phy/upper/rx_buffer_pool_impl.cpp).  Here the soft bits live in one
preallocated int8 tensor (nof_buffers, max_codeblocks, max_cb_size) on one
device, written in place; the host keeps only the (rnti, harq) -> buffer-index
reservation map, so HARQ combining happens on the device with no host round
trips.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.llr import llr_promotion_sum
from ..utils.tables import resolve_device


@dataclass
class _Reservation:
    buffer_index: int
    expiry_slot: int
    nof_cb: int


class RxBufferPool:
    """Host-managed reservation map over a device soft-buffer arena.  The
    full-size default holds 16 x 162 x 25344 int8 (about 66 MB) on `device`:
    the card unless the caller asks for the CPU."""

    def __init__(self, nof_buffers: int = 16, max_codeblocks: int = 162,
                 max_cb_size: int = 66 * 384, expiry_slots: int = 100, device="cuda"):
        self.nof_buffers = nof_buffers
        self.max_codeblocks = max_codeblocks
        self.max_cb_size = max_cb_size
        self.expiry_slots = expiry_slots
        self.device = resolve_device(device)
        self._soft = torch.zeros((nof_buffers, max_codeblocks, max_cb_size), dtype=torch.int8,
                                 device=self.device)
        self._reservations: dict[tuple[int, int], _Reservation] = {}
        self._free = list(range(nof_buffers))

    def reserve(self, slot: int, rnti: int, harq_id: int, nof_cb: int, *,
                new_data: bool) -> int | None:
        """Reserve (or re-acquire) the buffer for (rnti, harq). None if exhausted."""
        self.run_slot(slot)
        key = (rnti, harq_id)
        res = self._reservations.get(key)
        if res is not None and res.nof_cb == nof_cb:
            res.expiry_slot = slot + self.expiry_slots
            if new_data:
                self._soft[res.buffer_index, :nof_cb].zero_()
            return res.buffer_index
        if res is not None:
            self._release(key)
        if not self._free:
            return None
        idx = self._free.pop()
        self._reservations[key] = _Reservation(idx, slot + self.expiry_slots, nof_cb)
        self._soft[idx, :nof_cb].zero_()
        return idx

    def get_soft(self, buffer_index: int, nof_cb: int, cb_size: int) -> torch.Tensor:
        """View of the stored soft bits, (nof_cb, cb_size) int8.  A view: the
        caller reads it and never writes it; a later `store` (ordered after
        the read on the device's stream) replaces the contents."""
        return self._soft[buffer_index, :nof_cb, :cb_size]

    def store(self, buffer_index: int, nof_cb: int, cb_size: int, soft: torch.Tensor) -> None:
        """Replace the buffer contents with `soft` ((nof_cb, cb_size) int8)."""
        self._soft[buffer_index, :nof_cb, :cb_size].copy_(soft)

    def combined(self, buffer_index: int, nof_cb: int, cb_size: int,
                 new_llrs: torch.Tensor) -> torch.Tensor:
        """Promotion-sum `new_llrs` ((nof_cb, cb_size) int8) into the buffer.

        Returns the combined LLRs; stores them back as the new buffer state.
        """
        out = llr_promotion_sum(self.get_soft(buffer_index, nof_cb, cb_size), new_llrs)
        self.store(buffer_index, nof_cb, cb_size, out)
        return out

    def release(self, rnti: int, harq_id: int) -> None:
        """Free the buffer (e.g. after TB CRC pass)."""
        self._release((rnti, harq_id))

    def _release(self, key) -> None:
        res = self._reservations.pop(key, None)
        if res is not None:
            self._free.append(res.buffer_index)

    def run_slot(self, slot: int) -> None:
        """Expire stale reservations (reference: rx_buffer_pool expiry)."""
        for key, res in list(self._reservations.items()):
            if slot >= res.expiry_slot:
                self._release(key)

    @property
    def nof_reserved(self) -> int:
        return len(self._reservations)
