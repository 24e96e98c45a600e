"""Share of the traced calls' PUSCH rows whose receiver demapped with the
hand-written kernel: the port's counters `ul_demap_kernel_rows` over
`ul_demap_rows` (`phy.upper_phy.process_pusch_batch`), each summed over the
counter records of its FAPI entries (`utils.tracing.last_calls`) of the
traced calls.  None where no record holds the counters (a program that does
not count them) or no row was demapped.  The run makes no call of the
program after the traced window, so the newest records are the window's."""

COUNTER = "ul_demap_kernel_rows"
TOTAL = "ul_demap_rows"


def read(ctx):
    try:
        from srsran_projectvtlmo_tpu_torch.utils import tracing
    except ImportError:
        return None
    last_calls = getattr(tracing, "last_calls", None)
    if last_calls is None or not ctx.calls:
        return None
    records = last_calls(len(ctx.calls))
    if len(records) != len(ctx.calls):
        return None
    total = sum(r.get(TOTAL, 0) for r in records)
    if not total:
        return None
    return sum(r.get(COUNTER, 0) for r in records) / total
