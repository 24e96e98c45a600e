"""Share of the DL host values' PDCCH and PBCH encodes that were table
lookups: the port's counters `dl_table_encodes` over `dl_encodes`
(`phy.pdcch`, `phy.pbch`), each summed over the counter records of its FAPI
entries (`utils.tracing.last_calls`) of the traced calls.  None where no
record holds the counters (a program that does not count them) or no call
encoded.  The run makes no call of the program after the traced window, so
the newest records are the window's."""

COUNTER = "dl_table_encodes"
TOTAL = "dl_encodes"


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
