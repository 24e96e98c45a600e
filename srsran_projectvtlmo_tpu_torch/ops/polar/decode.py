"""Batched simplified-successive-cancellation (SSC) polar decoder (port of
`srsran_projectvtlmo_tpu.ops.polar.decode`).

Min-sum f/g recursion over the code tree.  The JAX package prunes the tree
while tracing; here it is pruned once per PolarCode into a cached node
schedule (`_schedule`), which `polar_decode` then runs on device tensors, so
no step leaves the device.  Constituent nodes, as in the reference's runtime
SSC dispatch (reference: lib/phy/upper/channel_coding/polar/
polar_decoder_impl.cpp:209-374):

 * rate-0 (all frozen): constant zeros, no recursion;
 * rate-1 (all info): per-position hard decision + one GF(2) butterfly;
 * repetition (info = last leaf only): sign of the LLR sum;
 * SPC (frozen = first leaf only): hard decisions with a parity flip at the
   least-reliable position (first index on ties).

Parity-check bits use the allocator's 5-stage cyclic register.  Pruned
subtrees update the register in closed form: after an m-leaf subtree,
final[q] = orig[(q+m) % 5] XOR (info bits u_j with (j+1-m) % 5 == q).

Ties follow JAX: sign(0) = 0 in f, bit 1 where the LLR is <= 0.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.tables import on_device
from .code import PolarCode
from .encode import polar_encode


@dataclass(frozen=True)
class _Node:
    """One node of the pruned tree over leaves [base, base + m)."""

    kind: str  # "rate0", "rate1", "rep", "spc", "frozen", "pc", "info", "split"
    base: int
    m: int
    #: Closed-form register update: per q, the local leaf indices XORed in.
    reg_js: tuple[tuple[int, ...], ...] = ()
    left: "_Node | None" = None
    right: "_Node | None" = None


def _reg_js(m: int, info_locals) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(j for j in info_locals if (j + 1 - m) % 5 == q) for q in range(5))


@functools.lru_cache(maxsize=None)
def _schedule(code: PolarCode) -> _Node:
    """The code tree with every prunable subtree replaced by its constituent node."""
    frozen = code.frozen_mask
    pc_set = set(code.pc_set.tolist())

    def build(base: int, m: int) -> _Node:
        sub = frozen[base:base + m]
        has_pc = any((base + j) in pc_set for j in range(m))
        if not has_pc and m >= 2:
            if sub.all():
                return _Node("rate0", base, m, _reg_js(m, []))
            if not sub.any():
                return _Node("rate1", base, m, _reg_js(m, range(m)))
            if sub[:-1].all() and not sub[-1]:
                return _Node("rep", base, m, _reg_js(m, [m - 1]))
            if sub[0] and not sub[1:].any():
                return _Node("spc", base, m, _reg_js(m, range(1, m)))
        if m == 1:
            kind = "frozen" if frozen[base] else ("pc" if base in pc_set else "info")
            return _Node(kind, base, 1)
        half = m // 2
        return _Node("split", base, m, left=build(base, half), right=build(base + half, half))

    return build(0, code.N)


def count_nodes(code: PolarCode) -> dict[str, int]:
    """Node kinds of the pruned tree (what one decode runs), for reports."""
    counts: dict[str, int] = {}

    def walk(node):
        counts[node.kind] = counts.get(node.kind, 0) + 1
        if node.kind == "split":
            walk(node.left)
            walk(node.right)

    walk(_schedule(code))
    return counts


def _index(js: tuple[int, ...]) -> np.ndarray:
    return np.asarray(js, np.int64)


def _reg_update(reg, node: _Node, u: torch.Tensor | None):
    """Closed-form PC-register update across a pruned subtree: final[q] =
    orig[(q+m)%5] ^ xor{u_j : (j+1-m)%5 == q}.  u: (..., m) subtree bits."""
    m = node.m
    out = [reg[(q + m) % 5] for q in range(5)]
    for q, js in enumerate(node.reg_js):
        if not js:
            continue
        if len(js) == 1:
            acc = u[..., js[0]]
        else:
            sel = u[..., on_device(_index, js, device=u.device)]
            acc = (sel.to(torch.int32).sum(dim=-1) & 1).to(torch.uint8)
        out[q] = out[q] ^ acc
    return tuple(out)


def _run(node: _Node, llr: torch.Tensor, reg):
    """-> (x (..., m) re-encoded bits, u (..., m) decoded bits, register)."""
    kind = node.kind
    if kind == "rate0":
        z = torch.zeros(llr.shape, dtype=torch.uint8, device=llr.device)
        return z, z, tuple(reg[(q + node.m) % 5] for q in range(5))
    if kind == "rate1":
        x = (llr <= 0).to(torch.uint8)
        u = polar_encode(x, node.m.bit_length() - 1)  # F is an involution over GF(2)
        return x, u, _reg_update(reg, node, u)
    if kind == "rep":
        bit = (llr.sum(dim=-1) <= 0).to(torch.uint8)
        x = bit[..., None].expand(llr.shape)
        u = torch.cat([torch.zeros(llr.shape[:-1] + (node.m - 1,), dtype=torch.uint8,
                                   device=llr.device), bit[..., None]], dim=-1)
        return x, u, _reg_update(reg, node, u)
    if kind == "spc":
        x = (llr <= 0).to(torch.uint8)
        parity = (x.to(torch.int32).sum(dim=-1) & 1).to(torch.uint8)
        amin = torch.argmin(llr.abs(), dim=-1)
        flip = torch.nn.functional.one_hot(amin, node.m).to(torch.uint8)
        x = x ^ (parity[..., None] * flip)
        u = polar_encode(x, node.m.bit_length() - 1)
        return x, u, _reg_update(reg, node, u)
    if kind in ("frozen", "pc", "info"):
        reg = (reg[1], reg[2], reg[3], reg[4], reg[0])
        lv = llr[..., 0]
        if kind == "frozen":
            bit = torch.zeros(lv.shape, dtype=torch.uint8, device=llr.device)
        elif kind == "pc":
            bit = reg[0]
        else:
            bit = (lv <= 0).to(torch.uint8)
            reg = (reg[0] ^ bit, reg[1], reg[2], reg[3], reg[4])
        return bit[..., None], bit[..., None], reg
    half = node.m // 2
    a, b = llr[..., :half], llr[..., half:]
    f = torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())
    xl, ul, reg = _run(node.left, f, reg)
    g = b + (1.0 - 2.0 * xl.to(llr.dtype)) * a
    xr, ur, reg = _run(node.right, g, reg)
    return torch.cat([xl ^ xr, xr], dim=-1), torch.cat([ul, ur], dim=-1), reg


def polar_decode(llrs: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, N) LLRs (int8 or float; positive = bit 0) -> (B, N) decoded u."""
    x = llrs.to(torch.float32)
    reg = tuple(torch.zeros(x.shape[:-1], dtype=torch.uint8, device=x.device)
                for _ in range(5))
    return _run(_schedule(code), x, reg)[1]
