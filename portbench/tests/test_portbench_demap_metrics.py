"""`ul_demap_kernel_share` reads the demap counters of the traced calls'
records: rows demapped by the kernel over all rows demapped."""

from types import SimpleNamespace

from portbench.layer_metrics import ul_demap_kernel_share
from srsran_projectvtlmo_tpu_torch.utils import tracing


def traced_calls(counts):
    """One closed entry record per call, (`ul_demap_rows`,
    `ul_demap_kernel_rows`) counted where given."""
    for pair in counts:
        with tracing.entry("test.call"):
            if pair is not None:
                tracing.count("ul_demap_rows", pair[0])
                tracing.count("ul_demap_kernel_rows", pair[1])
    return SimpleNamespace(calls=list(range(len(counts))), cell_slots=4 * len(counts))


def test_share_of_kernel_rows():
    assert ul_demap_kernel_share.read(traced_calls([(4, 4), (4, 4), (4, 0), (4, 4)])) == 0.75
    assert ul_demap_kernel_share.read(traced_calls([(4, 4), (1, 1)])) == 1.0
    assert ul_demap_kernel_share.read(traced_calls([(4, 0), (4, 0)])) == 0.0


def test_no_counter_reads_nothing():
    assert ul_demap_kernel_share.read(traced_calls([None, None])) is None
    assert ul_demap_kernel_share.read(traced_calls([(0, 0)])) is None
    assert ul_demap_kernel_share.read(SimpleNamespace(calls=[], cell_slots=0)) is None
