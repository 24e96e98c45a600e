"""Bytes uploaded host to device per cell-slot by the traced calls: the port's
counter `h2d_bytes` (`utils.tables.upload`), from the counter records of
its FAPI entries (`utils.tracing.last_calls`).  The run makes no call of the
program after the traced window, so the newest records are the window's."""

COUNTER = "h2d_bytes"


def read(ctx):
    try:
        from srsran_projectvtlmo_tpu_torch.utils import tracing
    except ImportError:
        return None
    last_calls = getattr(tracing, "last_calls", None)
    if last_calls is None or not ctx.calls or not ctx.cell_slots:
        return None
    records = last_calls(len(ctx.calls))
    if len(records) != len(ctx.calls):
        return None
    return sum(r.get(COUNTER, 0) for r in records) / ctx.cell_slots
