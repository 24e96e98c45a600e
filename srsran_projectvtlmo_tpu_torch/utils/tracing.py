"""The port's tracing: named host spans on torch.profiler's clock, and
per-call counters of the FAPI entries.

One clock and one switch.  A span is a `torch.profiler.record_function`
range while a profiler runs and a shared no-op otherwise, so host spans and
the card's kernels and copies land on one timeline (the profiler's), and a
span costs one flag test when nothing records.

An `entry` is the span of a FAPI entry point.  At nesting depth 0 (per
thread) it also opens a counter record, which `count` adds to and which
closes into `CALLS` when the outermost entry returns; a nested entry (the
multi-cell class falling back to one cell's `UpperPhy`) adds to the outer
record.  Counters always count: a few integer adds per call.

Counters: `h2d_bytes` (`utils.tables.upload`) and `d2h_bytes`
(`utils.tables.fetch`, `fetch_dl_outputs`), the bytes an entry moves between
host and device; `dl_graph_captures` and `dl_graph_replays` (`phy.dl_slot`),
the CUDA graphs of the DL slot captured and replayed (a DL slot run on a
card adds 0 replays when it runs eagerly); `dl_pinned_fetches`
(`utils.tables.fetch_dl_outputs`), DL fetches through pinned staging (0 on
the CPU); `dl_encodes` and `dl_table_encodes` (`phy.pdcch`, `phy.pbch`), the
PDCCH and PBCH codewords encoded, and of them those looked up in a table
that was already built (an encode that first builds its table adds 0);
`ul_graph_captures` and `ul_graph_replays` (`phy.ul_graph`), the PUSCH
receiver's CUDA graphs captured and replayed (an eager receiver call on a
card adds 0 replays; the CPU counts neither); `pusch_cbs`, `ldpc_sweeps` and
`crc_channel_states` (`phy.upper_phy.process_pusch_batch`), the PUSCH
codeblocks decoded, the sum of their LDPC iterations, and the CRC
indications that carry channel state; `ul_demap_rows` and
`ul_demap_kernel_rows` (the same function), the PUSCH rows demapped, and
of them those whose receiver's demap stage is the hand-written kernel
(`ops.pusch_demap`; 0 on the CPU).
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

#: Closed counter records, oldest first: {"entry": name, counter: int, ...}.
CALLS: collections.deque = collections.deque(maxlen=4096)

_OFF = contextlib.nullcontext()


class _State(threading.local):
    depth = 0
    record: dict | None = None


_STATE = _State()


def span(name: str):
    """A context manager: `record_function(name)` while a profiler runs, a
    no-op otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class _Entry:
    __slots__ = ("name", "_span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> dict:
        st = _STATE
        if st.depth == 0:
            st.record = {"entry": self.name}
        st.depth += 1
        self._span = span(self.name)
        self._span.__enter__()
        return st.record

    def __exit__(self, *exc) -> None:
        self._span.__exit__(*exc)
        st = _STATE
        st.depth -= 1
        if st.depth == 0:
            CALLS.append(st.record)
            st.record = None


def entry(name: str) -> _Entry:
    """The span of a FAPI entry point, which at depth 0 also opens the
    call's counter record (see the module docstring)."""
    return _Entry(name)


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` of the open record; nothing outside an entry."""
    rec = _STATE.record
    if rec is not None:
        rec[name] = rec.get(name, 0) + n


def last_calls(n: int) -> list[dict]:
    """The newest `n` closed records, oldest first."""
    if n <= 0:
        return []
    return list(CALLS)[-n:]


@contextlib.contextmanager
def profile(path: str, device):
    """torch.profiler around the block, the card's activity too when `device`
    is a card; its Chrome trace is written to `path` on exit."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
