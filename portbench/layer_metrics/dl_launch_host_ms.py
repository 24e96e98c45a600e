"""Host ms per cell-slot inside the port's span `dl_slot.run`: the host
issuing the DL slot's device work (`DlSlotProgram.run_stacked`)."""


def read(ctx):
    us = ctx.trace.span_us("dl_slot.run")
    return us / 1e3 / ctx.cell_slots if us and ctx.cell_slots else None
