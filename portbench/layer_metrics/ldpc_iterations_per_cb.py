"""LDPC sweeps per decoded codeblock in the traced calls: the port's counters
`ldpc_sweeps` (the sum of the decoder's iterations over the codeblocks of
each PUSCH) over `pusch_cbs` (the codeblocks), from the counter records of
its FAPI entries (`utils.tracing.last_calls`).  None where no record holds
them.  The run makes no call of the program after the traced window, so the
newest records are the window's."""


def read(ctx):
    try:
        from srsran_projectvtlmo_tpu_torch.utils import tracing
    except ImportError:
        return None
    last_calls = getattr(tracing, "last_calls", None)
    if last_calls is None or not ctx.calls:
        return None
    records = last_calls(len(ctx.calls))
    cbs = sum(r.get("pusch_cbs", 0) for r in records)
    if len(records) != len(ctx.calls) or not cbs:
        return None
    return sum(r.get("ldpc_sweeps", 0) for r in records) / cbs
