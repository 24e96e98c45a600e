"""Device ms of kernels per cell-slot in the traced window."""


def read(ctx):
    us = ctx.trace.kernel_us()
    return us / 1e3 / ctx.cell_slots if us and ctx.cell_slots else None
