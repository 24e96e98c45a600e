"""Stored transmit-side test data for runs on machines without JAX.

`tools/make_torch_fixture.py` runs the JAX transmitter (UL-SCH slot and LDPC
encoder) and writes one `.npz` with this module's `pack_fixture`;
`chip_smoke.py` reads it with `load_fixture`.  Contents:

  cfg_*                 the PUSCH configuration fields the slot was made with
  layer_grids           (B, L, 14, nsubc, 2) float16 Tx layer grids
  tb_bits               (B, ceil(tbs/8)) packed TB bits (np.packbits)
  ldpc_cases            (n, 5) int32 rows (bg, z, kp, crc order, nof filler)
  ldpc_<i>_cw           (ncw, ceil(N/8)) packed codewords without the two
                        punctured systematic columns (N = (nv - 2) * z)
"""

from __future__ import annotations

import numpy as np

#: CRC names by their order, for the LDPC codeword cases.
CRC_BY_ORDER = {24: "CRC24B", 16: "CRC16"}
CFG_FIELDS = ("nof_rb", "modulation", "target_code_rate", "nof_rx_ports", "nof_layers",
              "dft_size", "numerology", "tbs")


def pack_fixture(cfg_fields: dict, layer_grids: np.ndarray, tb_bits: np.ndarray,
                 ldpc_cases: list[tuple[tuple[int, int, int, int, int], np.ndarray]]) -> dict:
    """Arrays for `np.savez_compressed`; `ldpc_cases` is [((bg, z, kp, crc
    order, filler), codewords (ncw, N) uint8)]."""
    out = {f"cfg_{k}": np.asarray(cfg_fields[k]) for k in CFG_FIELDS}
    out["layer_grids"] = layer_grids.astype(np.float16)
    out["tb_bits"] = np.packbits(tb_bits.astype(np.uint8), axis=-1)
    out["ldpc_cases"] = np.asarray([c for c, _ in ldpc_cases], np.int32).reshape(-1, 5)
    for i, (_, cw) in enumerate(ldpc_cases):
        out[f"ldpc_{i}_cw"] = np.packbits(cw.astype(np.uint8), axis=-1)
    return out


def load_fixture(path) -> dict:
    """Inverse of `pack_fixture`: grids as float32, bits unpacked to uint8."""
    with np.load(path) as z:
        cfg = {k: z[f"cfg_{k}"].item() for k in CFG_FIELDS}
        tbs = int(cfg["tbs"])
        cases = []
        for i, row in enumerate(z["ldpc_cases"]):
            bg, zz, kp, order, filler = (int(v) for v in row)
            n = ((68 if bg == 1 else 52) - 2) * zz
            cw = np.unpackbits(z[f"ldpc_{i}_cw"], axis=-1)[:, :n]
            cases.append({"bg": bg, "z": zz, "kp": kp, "crc": CRC_BY_ORDER[order],
                          "filler": filler, "codewords": cw})
        return {
            "cfg": cfg,
            "layer_grids": z["layer_grids"].astype(np.float32),
            "tb_bits": np.unpackbits(z["tb_bits"], axis=-1)[:, :tbs],
            "ldpc": cases,
        }
