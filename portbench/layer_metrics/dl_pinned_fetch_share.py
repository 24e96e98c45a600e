"""Share of the traced calls whose DL fetch went through pinned staging:
the port's counter `dl_pinned_fetches` (`utils.tables.fetch_dl_outputs`),
summed over the counter records of its FAPI entries
(`utils.tracing.last_calls`), over the traced calls.  None where no record
holds the counter (a program that does not count it).  The run makes no
call of the program after the traced window, so the newest records are the
window's."""

COUNTER = "dl_pinned_fetches"


def read(ctx):
    try:
        from srsran_projectvtlmo_tpu_torch.utils import tracing
    except ImportError:
        return None
    last_calls = getattr(tracing, "last_calls", None)
    if last_calls is None or not ctx.calls:
        return None
    records = last_calls(len(ctx.calls))
    if len(records) != len(ctx.calls) or not any(COUNTER in r for r in records):
        return None
    return sum(r.get(COUNTER, 0) for r in records) / len(ctx.calls)
