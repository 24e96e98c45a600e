"""Kernels launched on the card per cell-slot in the traced window."""


def read(ctx):
    n = len(ctx.trace.kernels)
    return n / ctx.cell_slots if n and ctx.cell_slots else None
