"""Share of the traced calls whose PUSCH receiver replayed a CUDA graph: the
port's counter `ul_graph_replays` (`phy.ul_graph`, 1 per replay), summed
over the counter records of its FAPI entries (`utils.tracing.last_calls`),
over the traced calls.  None where no record holds the counter (a program
that does not count it).  The run makes no call of the program after the
traced window, so the newest records are the window's."""

COUNTER = "ul_graph_replays"


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
