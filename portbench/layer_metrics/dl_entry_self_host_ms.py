"""Host ms per cell-slot inside the port's DL entry spans and outside every
span nested in them: the entry's own work that no child span names.

Each outermost entry span (`upper_phy.process_dl_slot`, or
`multi_cell_phy.process_dl_slot` with the per-cell entries it may call)
counts its duration less the union of the other spans that lie inside it."""

import bisect

ENTRIES = ("upper_phy.process_dl_slot", "multi_cell_phy.process_dl_slot")
HARNESS = "portbench.call"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def read(ctx):
    spans = sorted((s, s + d, n) for n, s, d in ctx.trace.spans if n != HARNESS)
    starts = [s for s, _, _ in spans]
    self_us, end, found = 0.0, float("-inf"), False
    for s, e, n in spans:
        if n not in ENTRIES or e <= end:  # not an entry, or nested in one
            continue
        found, end = True, e
        inside, i = [], bisect.bisect_left(starts, s)
        while i < len(spans) and spans[i][0] <= e:
            cs, ce, cn = spans[i]
            if ce <= e and cn not in ENTRIES:
                inside.append((cs, ce))
            i += 1
        self_us += (e - s) - _union_us(inside)
    if not found or not ctx.cell_slots:
        return None
    return self_us / 1e3 / ctx.cell_slots
