"""Host ms per cell-slot inside the port's span `upper_phy.dl_values` (the
DL slot's values on the host and their upload)."""


def read(ctx):
    us = ctx.trace.span_us("upper_phy.dl_values")
    return us / 1e3 / ctx.cell_slots if us and ctx.cell_slots else None
