"""The LDPC decoder's share of its roofline in the traced window, in %: the
time the traced calls' decoding work needs at the card's bound over the
device time of the decoder's kernels (name containing `KERNEL`).

The work is counted from the traffic, so that any decoder reads the same
work: per traced call the codeblocks of its pool slot and the sweeps the
benchmark's reference decoder needs on the same samples (the traffic kind's
`Cell.ldpc_work`), a layered schedule that stops each codeblock at its
first zero syndrome, so the least a decode of the traffic needs; per
codeblock and sweep `OPS_PER_EDGE_LANE` operations on
each of the base graph's edge-lanes (BG1 z=384: 121,344), and per codeblock
its LLRs in and its decoded bits out, one byte each.  The bound takes the
larger of the operations at `PEAK_OPS` and the bytes at `PEAK_BYTES` (NVIDIA
H100 SXM: 132 SMs x 64 lanes x 2 halves of the packed 16-bit rate x 1.98
GHz; HBM3).  None where the trace holds no decoder kernel or the kind
counts no work."""

KERNEL = "ldpc_decode_kernel"
OPS_PER_EDGE_LANE = 10
PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12
#: BG1 at z = 384: 316 edges of the base graph x 384 lanes; 66 z codeword
#: LLRs in, 22 z decoded bits out.
EDGE_LANES = 316 * 384
BYTES_PER_CB = 66 * 384 + 22 * 384


def operations(sweeps: int) -> float:
    return float(OPS_PER_EDGE_LANE * EDGE_LANES * sweeps)


def bytes_moved(codeblocks: int) -> float:
    return float(BYTES_PER_CB * codeblocks)


def read(ctx):
    kernel_us = ctx.trace.kernel_us(KERNEL)
    work = getattr(ctx.cell, "ldpc_work", None)
    if not kernel_us or work is None or not ctx.calls:
        return None
    per_slot = {i: work(i) for i in set(ctx.calls)}
    cbs = sum(per_slot[i][0] for i in ctx.calls)
    sweeps = sum(per_slot[i][1] for i in ctx.calls)
    bound_s = max(operations(sweeps) / PEAK_OPS, bytes_moved(cbs) / PEAK_BYTES)
    return 100.0 * bound_s / (kernel_us * 1e-6)
