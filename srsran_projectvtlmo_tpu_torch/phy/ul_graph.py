"""The batched PUSCH receiver on a card, replayed as CUDA graphs.

`phy.upper_phy.process_pusch_batch` runs one call of the cached receiver of
its rows' shape (`models.pusch_rx.build_pusch_rx_from_grid`) per batch.  On a
card each replay key runs eagerly once, is captured as a CUDA graph on its
second call and replayed after that (`utils.cuda_graphs.GraphReplays`, as
for the DL slot).  The key is what the eager receiver branches on, on the
host: the receiver (its `pusch_rx_key`: the shape and the slot's OFDM
phase), the PDUs' `pusch_batch_key`, the batch size and whether HARQ soft
bits come in.  The HARQ arena stays outside the graph: a retransmission's
stored rows are copied into the graph's static input, and the caller copies
the combined soft bits from the graph's static output back into the arena.
A replayed call's kernels are not counted in `decode_cuda.LAUNCHES`, which
counts the launches of eager calls.

On the CPU the receiver runs eagerly, as it always has.  Counters
(`utils.tracing`): `ul_graph_captures`, 1 per capture, and
`ul_graph_replays`, 1 per replay and 0 per eager call on a card.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ..ops.ldpc import decode_cuda
from ..utils import cuda_graphs, tracing

#: Replay keys per receiver that keep a CUDA graph, the least recently used
#: evicted first: for example two batch sizes, each with and without HARQ
#: soft bits.
GRAPH_KEYS = 4
#: Receivers whose replay keys are kept (one per PUSCH shape and OFDM phase).
RECEIVERS = 32
#: The columns of the per-row summary `receive` adds as `rows`.
ROW_COLUMNS = ("tb_crc_ok", "ul_sinr_db", "timing_advance_ns", "evm", "ldpc_sweeps")


def receive(rx, grid, harq_in, ref_dmrs, signs, uci_fix) -> dict:
    """One call of the receiver `rx` on the allocation `grid`, with the
    per-row summary `rows` (B, 5) float32 added (`ROW_COLUMNS`: the TB CRC
    verdict as 1 or 0, the SINR in dB, the timing advance in ns, the EVM and
    the LDPC sweeps summed over the row's codeblocks), so that the verdicts
    and the channel state reach the host in one copy."""
    out = rx(grid, harq_in, ref_dmrs, signs, uci_fix)
    out["rows"] = row_summary(out["tb_crc_ok"], out, out["ldpc_iterations"])
    return out


def row_summary(tb_crc_ok: torch.Tensor, metrics: dict, iterations: torch.Tensor):
    """(B, 5) float32, `ROW_COLUMNS` per row: the verdicts (B,), the
    receiver's `snr_db`, `ta_s` and `evm` in `metrics`, and the LDPC
    iterations (B, C) summed over the codeblocks."""
    return torch.stack([tb_crc_ok.float(), metrics["snr_db"], metrics["ta_s"] * 1e9,
                        metrics["evm"], iterations.sum(dim=-1).float()], dim=-1)


def _flat(args) -> list:
    """(grid, harq_in, ref_dmrs, signs, uci_fix) as a flat list of tensors or
    None, the UCI fix signs' three fields last where given."""
    return list(args[:4]) + list(args[4] or ())


def _unflat(flat: list, has_uci: bool) -> tuple:
    return tuple(flat[:4]) + (tuple(flat[4:]) if has_uci else None,)


class _RxGraph:
    """One replay key's receiver call `fn` captured as a CUDA graph on static
    inputs shaped as the key's call.  `run` copies a call's inputs into
    them and replays; the outputs are the graph's static tensors, which the
    next replay overwrites."""

    def __init__(self, fn, args, pool):
        self.has_uci = args[4] is not None
        self.static = [None if a is None else torch.empty(a.shape, dtype=a.dtype, device=a.device)
                       for a in _flat(args)]
        self.graph = torch.cuda.CUDAGraph()
        # The capture records the kernels without launching them.
        before = dict(decode_cuda.LAUNCHES)
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.out = fn(*_unflat(self.static, self.has_uci))
        finally:
            decode_cuda.LAUNCHES.update(before)

    def run(self, args) -> dict:
        for dst, src in zip(self.static, _flat(args)):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        return self.out


@functools.lru_cache(maxsize=RECEIVERS)
def _replays(rx_cfg, device: torch.device) -> cuda_graphs.GraphReplays:
    return cuda_graphs.GraphReplays(device, GRAPH_KEYS, "ul_graph", "PUSCH receiver",
                                    span="pusch_rx.run")


@contextlib.contextmanager
def receiver_outputs(rx_cfg, key, fn, args):
    """The outputs of `fn(*args)`, a call of the receiver of `rx_cfg`
    (`upper_phy.pusch_rx_key`) through `receive`, valid inside the block: on
    a card through the CUDA graph of replay key `key` where it has one,
    eagerly elsewhere.  `args` is (grid, harq_in, ref_dmrs, signs, uci_fix),
    each a tensor or None, `uci_fix` a tuple of them.  Span `pusch_rx.run`:
    the host issuing the receiver."""
    dev = args[0].device
    if dev.type != "cuda":
        with tracing.span("pusch_rx.run"):
            out = fn(*args)
        yield out
        return
    with _replays(rx_cfg, dev).outputs(key, fn, args, _RxGraph) as out:
        yield out
