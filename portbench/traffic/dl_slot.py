"""Traffic kind `dl_slot`: per slot one DL_TTI and one TX_DATA request in
every cell: a PDSCH with a new TB, a PDCCH with a new DCI, and, where the
mix has them, an SSB with a new SFN and a CSI-RS.  The program's entry is
`process_dl_slot(request, tx_data, fetch=True)` (one cell) or
`(requests, tx_datas, fetch=True)` (`MultiCellUpperPhy`); a call ends when
the grid and the samples are on the host.

One call of each pool slot, drawn from the seed, is kept and held against
the reference (`reference.dl`, written from TS 38.211/38.212) once the
window has closed.
"""

from __future__ import annotations

import numpy as np

from ..pool import PoolSlot, per_cell
from ..reference import dl as ref_dl
from ..reference.fapi import pdus as ref_pdus

LIMITS = {
    # Calls that raised; exact.
    "dl_calls_failed": 0,
    # max |grid - reference grid| / reference peak, worst kept cell-slot.
    "dl_grid_err": 0.02,
    # RMS of samples - reference samples over the reference's RMS, worst
    # kept cell-slot.
    "dl_samples_rel_rms": 0.016,
}


def dft_precoder(nof_ports: int, nof_layers: int) -> tuple:
    """exp(-2 pi j p l / P) / 2 as the PDU's ((re, im), ...) rows."""
    w = np.exp(-2j * np.pi * np.outer(np.arange(nof_ports), np.arange(nof_layers))
               / nof_ports) / 2.0
    return tuple(tuple((float(c.real), float(c.imag)) for c in row) for row in w)


def dl_request(fapi, spec: dict, cell: dict, values: dict):
    """(DlTtiRequest, TxDataRequest) of one cell's DL slot, as `fapi`'s classes."""
    pdcch = fapi.PdcchPdu(rnti=values["rnti"], n_id=values["n_id"], n_rnti=values["rnti"],
                          **spec["pdcch"])
    object.__setattr__(pdcch, "payload", tuple(int(b) for b in values["dci"]))
    pd = spec["pdsch"]
    pdsch = fapi.PdschPdu(
        rnti=values["rnti"], rb_start=pd["rb_start"], rb_size=pd["rb_size"],
        modulation=fapi.Modulation[pd["modulation"]],
        target_code_rate=pd["target_code_rate_x1024"] / 1024.0, nof_layers=pd["nof_layers"],
        start_symbol=pd["start_symbol"], nof_symbols=pd["nof_symbols"],
        dmrs_symbols=tuple(pd["dmrs_symbols"]), n_id=values["n_id"],
        precoding=dft_precoder(cell["nof_tx_ports"], pd["nof_layers"]))
    extra = {}
    if "ssb" in spec:
        extra["ssb"] = (fapi.SsbPdu(sfn=values["sfn"], half_radio_frame=False, **spec["ssb"]),)
    if "csi_rs" in spec:
        extra["csi_rs"] = (fapi.CsiRsPdu(nof_rb=cell["nof_rb"], **spec["csi_rs"]),)
    req = fapi.DlTtiRequest(slot=values["slot"], pdcch=(pdcch,), pdsch=(pdsch,), **extra)
    return req, fapi.TxDataRequest(slot=values["slot"], tb_bits=[values["tb"]])


def make_pool(traffic, config, seed, device, fapi) -> list[PoolSlot]:
    """The mix's keys other than the pool's (`pdsch`, `pdcch`, `ssb`,
    `csi_rs`) are one cell's spec; `cells`, where given, lists one spec per
    cell (cycled) instead."""
    cell, ncell = config["cell"], config["nof_cells"]
    specs = per_cell(traffic.get("cells", traffic), ncell)
    rng = np.random.default_rng(seed)
    lo, hi = traffic["first_slot"]
    first = int(rng.integers(lo, hi + 1))
    pool = []
    for k in range(traffic["pool_slots"]):
        reqs, datas, refs = [], [], []
        for spec in specs:
            values = dict(slot=first + k, rnti=int(rng.integers(*traffic["rnti_range"])),
                          n_id=int(rng.integers(*traffic["n_id_range"])),
                          sfn=int(rng.integers(0, 1024)),
                          dci=rng.integers(0, 2, spec["pdcch"]["nof_dci_bits"]).astype(np.uint8),
                          tb=np.zeros(0, np.uint8))
            ref_req, _ = dl_request(ref_pdus, spec, cell, values)
            values["tb"] = rng.integers(0, 2, ref_dl.pdsch_tbs(ref_req.pdsch[0])).astype(np.uint8)
            req, data = dl_request(fapi, spec, cell, values)
            reqs.append(req)
            datas.append(data)
            refs.append(dl_request(ref_pdus, spec, cell, values))
        args = (reqs[0], datas[0]) if ncell == 1 else (reqs, datas)
        pool.append(PoolSlot(first + k, args, [None] * ncell, {"cells": refs}))
    return pool


def per_cell_outputs(out, ncell: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The entry's outputs as (grid complex (P, 14, nsubc), samples) per cell."""
    grid, samples = out
    if ncell == 1:
        return [(grid if np.iscomplexobj(grid) else grid[..., 0] + 1j * grid[..., 1], samples)]
    return [(g[..., 0] + 1j * g[..., 1], s) for g, s in zip(grid, samples)]


class Cell:
    def __init__(self, traffic, config, pool, phy, device, seed):
        self.config, self.pool, self.phy, self.device = config, pool, phy, device
        self.rng = np.random.default_rng([seed, 1])
        self.reset()

    def call(self, i: int):
        req, data = self.pool[i].args
        return self.phy.process_dl_slot(req, data, fetch=True)

    def record(self, i: int, out) -> int:
        if out is None:
            self.failed += self.config["nof_cells"]
            return self.config["nof_cells"]
        self.seen[i] += 1
        if self.rng.random() * self.seen[i] < 1.0:  # one call per pool slot, uniformly
            self.kept[i] = out
        return 0

    def reset(self) -> None:
        self.failed, self.seen, self.kept = 0, [0] * len(self.pool), {}

    def check(self) -> dict:
        """The kept outputs against the reference's grid and samples."""
        grid_err = rms = 0.0
        for i, out in sorted(self.kept.items()):
            for (g, s), (req, data) in zip(per_cell_outputs(out, self.config["nof_cells"]),
                                           self.pool[i].ref["cells"]):
                rg, rs = ref_dl.assemble(req, data, self.config["cell"], self.device)
                grid_err = max(grid_err, float(np.abs(g - rg).max() / np.abs(rg).max()))
                rms = max(rms, float(np.sqrt(np.mean((s - rs) ** 2) / np.mean(rs ** 2))))
        return {"dl_calls_failed": self.failed, "dl_grid_err": grid_err,
                "dl_samples_rel_rms": rms}


class Reference:
    """The reference in the program's place, its grid stored at `precision`."""

    def __init__(self, pool, config, device, precision: str):
        self.by_request = {id(e.args[0]): e for e in pool}
        self.config, self.device, self.precision = config, device, precision

    def process_dl_slot(self, request, tx_data, fetch=True):
        outs = [ref_dl.assemble(req, data, self.config["cell"], self.device, self.precision)
                for req, data in self.by_request[id(request)].ref["cells"]]
        if self.config["nof_cells"] == 1:
            return outs[0]
        return (np.stack([np.stack([g.real, g.imag], -1) for g, _ in outs]),
                np.stack([s for _, s in outs]))


CONTROLS = {
    # The reference with its grid in float8 e4m3, the precision below the
    # bfloat16 grid that the configuration states.
    "ref_fp8": lambda make_phy, pool, config, device: Reference(pool, config, device, "fp8"),
}
