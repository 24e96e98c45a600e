"""Host ms per cell-slot inside the port's span `upper_phy.ul_fetch`: from the
PUSCH receiver's issue to its CRC verdicts, channel state, TB bits and UCI
on the host (the wait for the device and the copies)."""


def read(ctx):
    us = ctx.trace.span_us("upper_phy.ul_fetch")
    return us / 1e3 / ctx.cell_slots if us and ctx.cell_slots else None
