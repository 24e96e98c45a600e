"""`dl_pinned_fetch_share` reads the counter records of the traced calls,
`dl_fetch_wait_host_ms` the fetch's wait span."""

from types import SimpleNamespace

from portbench import trace as trace_mod
from portbench.layer_metrics import dl_fetch_wait_host_ms, dl_pinned_fetch_share
from srsran_projectvtlmo_tpu_torch.utils import tracing


def traced_calls(counts):
    """One closed entry record per call, `dl_pinned_fetches` counted where given."""
    for n in counts:
        with tracing.entry("test.call"):
            if n is not None:
                tracing.count("dl_pinned_fetches", n)
    return SimpleNamespace(calls=list(range(len(counts))), cell_slots=len(counts))


def test_share_of_pinned_fetches():
    assert dl_pinned_fetch_share.read(traced_calls([1, 1, 0, 1])) == 0.75
    assert dl_pinned_fetch_share.read(traced_calls([0, 0])) == 0.0


def test_no_counter_reads_nothing():
    assert dl_pinned_fetch_share.read(traced_calls([None, None])) is None
    assert dl_pinned_fetch_share.read(SimpleNamespace(calls=[], cell_slots=0)) is None


def test_wait_span_per_cell_slot():
    spans = [("upper_phy.dl_fetch", 0.0, 900.0), ("upper_phy.dl_fetch_wait", 10.0, 600.0),
             ("upper_phy.dl_fetch", 1000.0, 800.0), ("upper_phy.dl_fetch_wait", 1010.0, 400.0)]
    ctx = SimpleNamespace(trace=trace_mod.Trace(spans=spans), cell_slots=2)
    assert dl_fetch_wait_host_ms.read(ctx) == 0.5


def test_no_wait_span_reads_nothing():
    ctx = SimpleNamespace(trace=trace_mod.Trace(spans=[("upper_phy.dl_fetch", 0.0, 9.0)]),
                          cell_slots=1)
    assert dl_fetch_wait_host_ms.read(ctx) is None
