"""Host ms per cell-slot inside the port's span `upper_phy.dl_fetch`: from
the first device-to-host copy of the DL entry to its returned arrays (the
wait for the device, the copies, the host-side conversions)."""


def read(ctx):
    us = ctx.trace.span_us("upper_phy.dl_fetch")
    return us / 1e3 / ctx.cell_slots if us and ctx.cell_slots else None
