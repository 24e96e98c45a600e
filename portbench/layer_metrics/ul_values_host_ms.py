"""Host ms per cell-slot inside the port's span `upper_phy.ul_values` (the
PUSCH rows' DM-RS references, descrambling signs and UCI fix signs on the
host, and their uploads)."""


def read(ctx):
    us = ctx.trace.span_us("upper_phy.ul_values")
    return us / 1e3 / ctx.cell_slots if us and ctx.cell_slots else None
