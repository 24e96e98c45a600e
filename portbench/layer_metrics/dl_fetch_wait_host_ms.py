"""Host ms per cell-slot inside the port's span `upper_phy.dl_fetch_wait`:
the DL fetch's one wait, on the event recorded after its copies into pinned
staging (the device finishing the slot, then the copies).  None where no
such span was recorded (a program without it, or a fetch on the CPU)."""


def read(ctx):
    us = ctx.trace.span_us("upper_phy.dl_fetch_wait")
    return us / 1e3 / ctx.cell_slots if us and ctx.cell_slots else None
