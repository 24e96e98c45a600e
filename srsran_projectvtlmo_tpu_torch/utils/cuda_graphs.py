"""CUDA graphs replayed per key, for the programs that run one device call per
slot on a card: the DL slot program (`phy.dl_slot`) and the PUSCH receiver
(`phy.ul_graph`).

A replay key is what the eager call branches on, on the host.  Each key runs
eagerly on its first call, is captured on its second and replayed after
that: one graph launch in place of the call's kernels, the same kernels on
the same inputs.  A capture whose `torch.cuda.graph` raises leaves its key
eager, said once in the PHY log.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from . import log, tracing

#: The state of a replay key seen once (its next call captures) and of one
#: whose capture failed (it runs eagerly).
_WARM, _EAGER = "warm", "eager"


class GraphReplays:
    """The replay keys of one program on one card and their graphs, which
    share one memory pool; at most `nof_keys` keys, the least recently used
    evicted first.

    `outputs(key, fn, args, graph_cls)` yields `fn(*args)`: eagerly on the
    key's first call, through `graph_cls(fn, args, pool)` (the capture, on
    static inputs shaped as `args`) on its second, through that graph's
    `run(args)` (copy-in and replay) on the second and later ones.  The
    outputs of a replay are the graph's own tensors, valid inside the block.
    The calls of one program are serial (the lock on the host, held inside
    the block; on the device each copy-in waits for the previous block's
    end, whatever stream it ran on), so a replay never overwrites outputs
    still in use.  Counters (`utils.tracing`): `<name>_captures`, 1 per
    capture, and `<name>_replays`, 1 per replay and 0 per eager call.  Span
    `span`, where given: the host issuing the eager call or the replay.
    """

    def __init__(self, device: torch.device, nof_keys: int, name: str, what: str,
                 span: str | None = None):
        self.device, self.nof_keys, self.name, self.what = device, nof_keys, name, what
        self.span = span
        #: The keys' states, least recently used first: a graph, `_WARM` or `_EAGER`.
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle()
        self._done = torch.cuda.Event()

    @contextlib.contextmanager
    def outputs(self, key, fn, args, graph_cls):
        with self._lock:
            state = self.graphs.get(key)
            if state is None:
                self.graphs[key] = _WARM
                if len(self.graphs) > self.nof_keys:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
            if state is _WARM:
                state = self.graphs[key] = self._capture(key, fn, args, graph_cls)
            if not isinstance(state, graph_cls):
                tracing.count(f"{self.name}_replays", 0)
                with self._issue():
                    out = fn(*args)
                yield out
                return
            stream = torch.cuda.current_stream(self.device)
            with self._issue():
                stream.wait_event(self._done)
                out = state.run(args)
            tracing.count(f"{self.name}_replays", 1)
            try:
                yield out
            finally:
                self._done.record(stream)

    def _issue(self):
        return contextlib.nullcontext() if self.span is None else tracing.span(self.span)

    def _capture(self, key, fn, args, graph_cls):
        try:
            graph = graph_cls(fn, args, self._pool)
        except RuntimeError as exc:
            log.get_logger("PHY").warning(
                "%s graph capture failed for replay key %s; the key runs eagerly: %s",
                self.what, key, exc)
            return _EAGER
        tracing.count(f"{self.name}_captures", 1)
        return graph
