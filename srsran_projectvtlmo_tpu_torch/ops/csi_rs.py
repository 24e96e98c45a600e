"""NZP-CSI-RS generation (TS 38.211 Section 7.4.1.5): full mapping-table
row set 1-12 with per-row port counts, densities and CDM.

Gold-sequence QPSK pilots; the RE locations per port come from Table
7.4.1.5.3-1 (k_bar/l_bar per row) and the CDM weights from Tables
7.4.1.5.3-2..4 (no CDM, fd-CDM2, cdm4-FD2-TD2).  Everything here is
host-side numpy producing the per-port values and grid positions that the
DL slot assembly adds to the grid (phy/dl_slot.py).
reference: lib/phy/upper/signal_processors/nzp_csi_rs_generator_impl.cpp:89-198,
lib/ran/csi_rs/csi_rs_pattern.cpp:33-438,
lib/ran/csi_rs/csi_rs_config_helpers.cpp:124-155.

The port's own copy of `srsran_projectvtlmo_tpu.ops.csi_rs`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import prg as prg_mod

#: Ports per mapping table row (reference: csi_rs_config_helpers.cpp:124;
#: rows 13-18 cover the 24/32-port arrays the reference's own pattern
#: builder stops short of — implemented here straight from TS 38.211
#: Table 7.4.1.5.3-1).
ROW_PORTS = {1: 1, 2: 1, 3: 2, 4: 4, 5: 4, 6: 8, 7: 8, 8: 8, 9: 12, 10: 12,
             11: 16, 12: 16, 13: 24, 14: 24, 15: 24, 16: 32, 17: 32, 18: 32}
#: CDM type per row: "no", "fd2" (fd-CDM2), "cdm4" (CDM4-FD2-TD2) or
#: "cdm8" (CDM8-FD2-TD4).
ROW_CDM = {1: "no", 2: "no", 3: "fd2", 4: "fd2", 5: "fd2", 6: "fd2",
           7: "fd2", 8: "cdm4", 9: "fd2", 10: "cdm4", 11: "fd2", 12: "cdm4",
           13: "fd2", 14: "cdm4", 15: "cdm8", 16: "fd2", 17: "cdm4",
           18: "cdm8"}
_CDM_SIZE = {"no": 1, "fd2": 2, "cdm4": 4, "cdm8": 8}
#: Number of k references each row consumes.
ROW_NOF_KREF = {1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 4, 7: 2, 8: 2, 9: 6, 10: 3,
                11: 4, 12: 4, 13: 3, 14: 3, 15: 3, 16: 4, 17: 4, 18: 4}


@dataclass(frozen=True)
class CsiRsConfig:
    nof_rb: int
    prb_start: int = 0
    #: Mapping table row (TS 38.211 Table 7.4.1.5.3-1), 1..12.
    row: int = 2
    #: Frequency allocation references k_0..k_n (row-dependent count);
    #: row 2 uses subcarrier_offset for backward compatibility when k_ref
    #: is left empty.
    k_ref: tuple[int, ...] = ()
    symbol: int = 4  # l_0
    symbol_l1: int = 8  # l_1 (unused by rows 1-12)
    #: "one", "three", "dot5_even" or "dot5_odd".
    density: str = "one"
    #: Legacy row-2 alias for k_ref[0].
    subcarrier_offset: int = 0
    scrambling_id: int = 0
    slot: int = 0
    amplitude: float = 1.0

    @property
    def k_refs(self) -> tuple[int, ...]:
        if self.k_ref:
            return self.k_ref
        return (self.subcarrier_offset,) * ROW_NOF_KREF[self.row]

    @property
    def nof_ports(self) -> int:
        return ROW_PORTS[self.row]


def csi_rs_cinit(cfg: CsiRsConfig, symbol: int | None = None) -> int:
    sym = cfg.symbol if symbol is None else symbol
    return (
        (1 << 10) * (14 * cfg.slot + sym + 1) * (2 * cfg.scrambling_id + 1)
        + cfg.scrambling_id
    ) % (1 << 31)


def _kbar_lbar(cfg: CsiRsConfig) -> list[tuple[int, int]]:
    """Per-port (k_bar, l_bar), following the reference row formulas
    (rows 13-18: TS 38.211 Table 7.4.1.5.3-1 directly — both l_0 and l_1
    references, CDM groups k-major within each l)."""
    row, k, l0, l1 = cfg.row, cfg.k_refs, cfg.symbol, cfg.symbol_l1
    csize = _CDM_SIZE[ROW_CDM[row]]
    out = []
    for p in range(ROW_PORTS[row]):
        g = p // csize
        if row in (1, 2, 3):
            out.append((k[0], l0))
        elif row == 4:
            out.append((k[0] + 2 * g, l0))
        elif row == 5:
            out.append((k[0], l0 + g))
        elif row == 7:
            out.append((k[g % 2], l0 + g // 2))
        elif row == 11:
            out.append((k[g % 4], l0 + g // 4))
        elif row == 13:
            out.append((k[g % 3], (l0, l0 + 1, l1, l1 + 1)[g // 3]))
        elif row == 14:
            out.append((k[g % 3], l0 if g < 3 else l1))
        elif row == 16:
            out.append((k[g % 4], (l0, l0 + 1, l1, l1 + 1)[g // 4]))
        elif row == 17:
            out.append((k[g % 4], l0 if g < 4 else l1))
        else:  # rows 6, 8, 9, 10, 12, 15, 18: k_ref indexed by CDM group
            out.append((k[g], l0))
    return out


def _occupied_rbs(cfg: CsiRsConfig) -> np.ndarray:
    """Absolute PRB indices carrying CSI-RS for this density."""
    rbs = np.arange(cfg.prb_start, cfg.prb_start + cfg.nof_rb)
    if cfg.density == "dot5_even":
        return rbs[rbs % 2 == 0]
    if cfg.density == "dot5_odd":
        return rbs[rbs % 2 == 1]
    return rbs


def _sequence(cfg: CsiRsConfig, symbol: int, seq_len: int,
              nof_advance: int) -> np.ndarray:
    """QPSK Gold pilots r(m) for one symbol, skipping `nof_advance` symbols
    below the first occupied PRB (reference: get_nof_skipped_elements)."""
    bits = prg_mod.gold_sequence_bits(
        csi_rs_cinit(cfg, symbol), 2 * (nof_advance + seq_len)
    ).astype(np.float32)[2 * nof_advance:]
    amp = np.float32(cfg.amplitude / np.sqrt(2.0))
    return (amp * (1 - 2 * bits[0::2])
            + 1j * amp * (1 - 2 * bits[1::2])).astype(np.complex64)


#: CDM weights (w_f, w_t) per in-group index (TS 38.211 Tables 7.4.1.5.3-2..5).
_W_FD2 = [((1, 1), (1,)), ((1, -1), (1,))]
_W_CDM4 = [((1, 1), (1, 1)), ((1, -1), (1, 1)),
           ((1, 1), (1, -1)), ((1, -1), (1, -1))]
_W_CDM8 = [((1, 1), (1, 1, 1, 1)), ((1, -1), (1, 1, 1, 1)),
           ((1, 1), (1, -1, 1, -1)), ((1, -1), (1, -1, 1, -1)),
           ((1, 1), (1, 1, -1, -1)), ((1, -1), (1, 1, -1, -1)),
           ((1, 1), (1, -1, -1, 1)), ((1, -1), (1, -1, -1, 1))]


def csi_rs_pattern(cfg: CsiRsConfig):
    """Per-port RE values and positions.

    Returns a list over ports of (symbols (S,), subc (n,), values (S, n)
    complex64): for each of the port's CDM symbols, the absolute carrier
    subcarrier indices and pilot values (CDM weights applied).
    """
    row = cfg.row
    cdm = ROW_CDM[row]
    csize = _CDM_SIZE[cdm]
    rbs = _occupied_rbs(cfg)
    kl = _kbar_lbar(cfg)

    # Sequence-element skip below the first occupied PRB.
    first_prb = int(rbs[0]) if len(rbs) else 0
    if cfg.density == "three":
        nof_advance = 3 * first_prb
    elif cfg.density == "one":
        nof_advance = first_prb if row == 2 else 2 * first_prb
    else:  # dot5: one (row 2) or two (fd/cdm rows) elements per OCCUPIED RB
        nof_advance = (first_prb // 2) if row == 2 else first_prb

    out = []
    for p, (kbar, lbar) in enumerate(kl):
        idx = p % csize
        if cdm == "no":
            wf, wt = (1,), (1,)
        elif cdm == "fd2":
            wf, wt = _W_FD2[idx]
        elif cdm == "cdm4":
            wf, wt = _W_CDM4[idx]
        else:
            wf, wt = _W_CDM8[idx]
        if row == 1:
            k_off = np.array([kbar, kbar + 4, kbar + 8])
        elif cdm == "no":
            k_off = np.array([kbar])
        else:
            k_off = np.array([kbar, kbar + 1])
        symbols = np.array([lbar + t for t in range(len(wt))])
        subc = (rbs[:, None] * 12 + k_off[None, :]).reshape(-1)
        seq_len = len(rbs) * len(k_off)
        vals = np.zeros((len(symbols), len(subc)), np.complex64)
        per_rb = np.tile(np.asarray(wf, np.complex64), len(k_off) // len(wf))
        wf_tile = np.tile(per_rb, len(rbs))
        for si, sym in enumerate(symbols):
            r = _sequence(cfg, int(sym), seq_len, nof_advance)
            vals[si] = r * wf_tile * np.complex64(wt[si])
        out.append((symbols, subc, vals))
    return out


def csi_rs_sequence(cfg: CsiRsConfig) -> np.ndarray:
    """Row-2 single-port pilots, one RE per occupied RB: (n_rb_occ,) complex64.

    Backward-compatible helper (the general path is `csi_rs_pattern`)."""
    assert cfg.row == 2, "csi_rs_sequence is the row-2 fast path"
    _, _, vals = csi_rs_pattern(cfg)[0]
    return vals[0]


def map_csi_rs(grid: np.ndarray, cfg: CsiRsConfig, port: int = 0) -> None:
    """Scatter one port's CSI-RS pilots into a (nsym, nsubc) numpy grid in
    place (test/oracle helper)."""
    symbols, subc, vals = csi_rs_pattern(cfg)[port]
    for si, sym in enumerate(symbols):
        grid[int(sym), subc] = vals[si]
