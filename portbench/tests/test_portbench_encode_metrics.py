"""`dl_table_encode_share` reads the encode counters of the traced calls'
records: table lookups over all encodes."""

from types import SimpleNamespace

from portbench.layer_metrics import dl_table_encode_share
from srsran_projectvtlmo_tpu_torch.utils import tracing


def traced_calls(counts):
    """One closed entry record per call, (`dl_encodes`, `dl_table_encodes`)
    counted where given."""
    for pair in counts:
        with tracing.entry("test.call"):
            if pair is not None:
                tracing.count("dl_encodes", pair[0])
                tracing.count("dl_table_encodes", pair[1])
    return SimpleNamespace(calls=list(range(len(counts))), cell_slots=len(counts))


def test_share_of_table_encodes():
    assert dl_table_encode_share.read(traced_calls([(2, 2), (2, 2), (2, 0), (2, 2)])) == 0.75
    assert dl_table_encode_share.read(traced_calls([(2, 2), (1, 1)])) == 1.0
    assert dl_table_encode_share.read(traced_calls([(2, 2), None])) == 1.0


def test_no_counter_reads_nothing():
    assert dl_table_encode_share.read(traced_calls([None, None])) is None
    assert dl_table_encode_share.read(traced_calls([(0, 0)])) is None
    assert dl_table_encode_share.read(SimpleNamespace(calls=[], cell_slots=0)) is None
