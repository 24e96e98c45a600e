"""`dl_graph_replay_share` reads the counter records of the traced calls."""

from types import SimpleNamespace

from portbench.layer_metrics import dl_graph_replay_share
from srsran_projectvtlmo_tpu_torch.utils import tracing


def traced_calls(counts):
    """One closed entry record per call, `dl_graph_replays` counted where given."""
    for n in counts:
        with tracing.entry("test.call"):
            if n is not None:
                tracing.count("dl_graph_replays", n)
    return SimpleNamespace(calls=list(range(len(counts))), cell_slots=len(counts))


def test_share_of_replayed_calls():
    assert dl_graph_replay_share.read(traced_calls([1, 1, 0, 1])) == 0.75


def test_no_counter_reads_nothing():
    assert dl_graph_replay_share.read(traced_calls([None, None])) is None
    assert dl_graph_replay_share.read(SimpleNamespace(calls=[], cell_slots=0)) is None
