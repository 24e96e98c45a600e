"""LDPC lifted base graphs (TS 38.212 Section 5.3.2), host-side tables.

A copy of the decoder's part of `srsran_projectvtlmo_tpu.ops.ldpc.graphs`
(whose package `__init__` imports jax; the encode plan comes with the
encoder), reading the same data file by path; the tests hold every field
equal to the original for BG1/BG2 x all 51 lifting sizes.

Convention: check (r, i) reads variable block c at rotated index
(i + shift[r, c]) mod Z.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph, lifting_index

NO_EDGE = 0xFFFF

_DATA = (Path(__file__).resolve().parents[3] / "srsran_projectvtlmo_tpu" / "data"
         / "ldpc_base_graphs.npz")


@functools.lru_cache(maxsize=1)
def _raw_tables() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {"bg1": z["bg1"], "bg2": z["bg2"]}


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
                     max_row_degree=max_deg, row_cols=row_cols, row_shifts=row_shifts)
