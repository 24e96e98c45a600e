"""LDPC lifted base graphs (TS 38.212 Section 5.3.2), host-side tables.

A copy of `srsran_projectvtlmo_tpu.ops.ldpc.graphs` (whose package
`__init__` imports jax), reading the port's own copy of the data file
(`data/ldpc_base_graphs.npz`); the tests hold every field, the encode plan
included, and the data file array by array, equal to the originals for
BG1/BG2 x all 51 lifting sizes.

Convention: check (r, i) reads variable block c at rotated index
(i + shift[r, c]) mod Z.
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ...ran.ldpc_params import BaseGraph, lifting_index

NO_EDGE = 0xFFFF

_DATA = Path(__file__).resolve().parents[2] / "data" / "ldpc_base_graphs.npz"


@functools.lru_cache(maxsize=1)
def _raw_tables() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {"bg1": z["bg1"], "bg2": z["bg2"]}


@dataclass(frozen=True)
class EncodePlan:
    """Telescoped core-parity solve for the double-diagonal structure.

    p0_shift: a, where XOR of the four core-row lambdas equals rot(p0, a).
    solve_order: (parity_local_idx in 1..3, core_row) in the order p1..p3 are
        recovered, each from a row where it is the only unsolved parity (with
        shift 0 on its own column).
    """

    p0_shift: int
    solve_order: tuple[tuple[int, int], ...]


@dataclass(frozen=True)
class LdpcGraph:
    bg: BaseGraph
    z: int
    #: Info-block columns K_b (22 / 10), check rows M (46 / 42), variable nodes N_full.
    kb: int
    m: int
    n_full: int
    #: (M, N_full) int32 shifts mod Z; -1 marks no edge.
    shifts: np.ndarray
    encode_plan: EncodePlan
    max_row_degree: int
    #: (M, max_row_degree) int32 column index per row edge, ascending; -1 padding.
    row_cols: np.ndarray
    #: (M, max_row_degree) int32 shift per row edge; 0 padding.
    row_shifts: np.ndarray

    @property
    def k(self) -> int:
        return self.kb * self.z

    @property
    def n(self) -> int:
        """Codeword bits after puncturing the first two systematic blocks."""
        return (self.n_full - 2) * self.z


def _derive_encode_plan(shifts: np.ndarray, kb: int) -> EncodePlan:
    """Derive and verify the core-parity solve from the table structure
    (reference: lib/phy/upper/channel_coding/ldpc/ldpc_encoder_generic.cpp:33-121)."""
    # XOR of core rows 0..3 leaves only p0 terms; shifts that appear an even
    # number of times cancel over GF(2).
    parity_terms = Counter()
    for r in range(4):
        for local, c in enumerate(range(kb, kb + 4)):
            if shifts[r, c] >= 0:
                parity_terms[(local, shifts[r, c])] += 1
    odd = [(local, s) for (local, s), cnt in parity_terms.items() if cnt % 2 == 1]
    if len(odd) != 1 or odd[0][0] != 0:
        raise AssertionError(f"core block does not telescope to p0: odd terms {odd}")

    solved = {0}
    order: list[tuple[int, int]] = []
    while len(solved) < 4:
        progress = False
        for r in range(4):
            present = [local for local, c in enumerate(range(kb, kb + 4)) if shifts[r, c] >= 0]
            unsolved = [q for q in present if q not in solved]
            if len(unsolved) == 1:
                q = unsolved[0]
                if shifts[r, kb + q] != 0:
                    raise AssertionError(f"row {r}: unsolved parity {q} has shift {shifts[r, kb + q]}")
                order.append((q, r))
                solved.add(q)
                progress = True
        if not progress:
            raise AssertionError("core parity back-substitution stuck")
    return EncodePlan(p0_shift=int(odd[0][1]), solve_order=tuple(order))


@functools.lru_cache(maxsize=None)
def get_graph(bg: BaseGraph, z: int) -> LdpcGraph:
    raw = _raw_tables()["bg1" if bg == BaseGraph.BG1 else "bg2"]
    mat = raw[lifting_index(z)].astype(np.int64)
    shifts = np.where(mat == NO_EDGE, -1, mat % z).astype(np.int32)
    kb, m, n_full = (22, 46, 68) if bg == BaseGraph.BG1 else (10, 42, 52)
    degrees = (shifts >= 0).sum(axis=1)
    max_deg = int(degrees.max())
    row_cols = np.full((m, max_deg), -1, dtype=np.int32)
    row_shifts = np.zeros((m, max_deg), dtype=np.int32)
    for r in range(m):
        cols = np.flatnonzero(shifts[r] >= 0)
        row_cols[r, :len(cols)] = cols
        row_shifts[r, :len(cols)] = shifts[r, cols]
    return LdpcGraph(bg=bg, z=z, kb=kb, m=m, n_full=n_full, shifts=shifts,
                     encode_plan=_derive_encode_plan(shifts, kb), max_row_degree=max_deg,
                     row_cols=row_cols, row_shifts=row_shifts)


def lifted_parity_matrix(graph: LdpcGraph) -> np.ndarray:
    """Full dense lifted H (M*Z, N_full*Z) uint8, for tests only."""
    z = graph.z
    h = np.zeros((graph.m * z, graph.n_full * z), dtype=np.uint8)
    eye = np.eye(z, dtype=np.uint8)
    for r in range(graph.m):
        for c in range(graph.n_full):
            s = graph.shifts[r, c]
            if s >= 0:
                h[r * z:(r + 1) * z, c * z:(c + 1) * z] = np.roll(eye, -s, axis=0)
    return h
