"""Traffic kind `ul_pusch`: per slot one UL_TTI request in every cell, each
with one new-data PUSCH of the mix's shape, a new TB, RNTI and n_id, and
the cell's received samples.  The program's entry is
`process_ul_slot(requests, samples)` (`MultiCellUpperPhy`) or
`(request, samples)` (one cell, `UpperPhy`); a call ends when its
indications are on the host.  The samples reach the program as a float32
tensor in pinned host memory, as a fronthaul receiver that writes into
registered buffers hands them over.

The UE side (`reference.ul.transmit`) makes each row's samples from the
seed: the TB through the fixed channel `channel_amplitude exp(-2 pi j p l /
P)` (rx port p, layer l), delayed by a whole number of samples drawn from
`delay_samples`, with white noise of the cell's `noise_std` per real
component.  The truth of a row is what the UE side did: the TB it encoded,
the delay it applied and the SINR its channel and noise give
(`reference.ul.true_sinr_db`).

Each call's CRC verdicts are read as the window runs: a cell-slot whose CRC
indication is missing or failed counts as failed.  One call of each pool
slot, drawn from the seed, is kept and held, once the window has closed,
against the truth and against the reference receiver (`reference.ul`,
written from TS 38.211/38.212/38.214): every TB bit for bit, and the SINR
and timing advance the CRC indication reports.  The program has to report
them: `Cell` looks for them before the warm-up and raises without them.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..harness import PORT
from ..pool import PoolSlot, per_cell
from ..reference import ul as ref_ul
from ..reference.fapi import pdus as ref_pdus

LIMITS = {
    # Cell-slots of the window whose call raised or whose CRC indication is
    # missing or failed; exact: the configuration guarantees every TB.
    "ul_calls_failed": 0,
    # Kept cell-slots whose TB is not the UE side's bit for bit (or whose
    # CRC failed); exact.  The float8 reference fails here, 32 of 32.
    # Readings below: the program on 24 seeds of 32 cell-slots each, the
    # controls on 4 of them (`control.py`, one H100).
    "ul_tb_wrong": 0,
    # |SINR reported - the reference receiver's|, dB, worst kept cell-slot:
    # the program 0.061-0.135, one constant SINR for every cell 4.55 or
    # more, the float8 reference 16.1 or more.
    "ul_sinr_vs_ref_db": 1.0,
    # |SINR reported - the post-MMSE SINR of the UE side's channel and
    # noise|, dB: the program 0.123-0.255, a constant SINR 4.52, the float8
    # reference 16.1 or more.
    "ul_sinr_vs_truth_db": 1.0,
    # |TA reported - the reference receiver's|, ns: the program 0.019-0.050
    # (the reference's phase-slope estimate is continuous), the float8
    # reference 0.34-0.42, a constant TA 33.6 or more.
    "ul_ta_vs_ref_ns": 0.15,
    # |TA reported - the delay the UE side applied|, ns: the delays are
    # whole samples at 122.88 MHz, which the port's 4096-point IDFT search
    # lands on (under 1e-5 ns of float32 rounding); the float8 reference
    # reads 0.34-0.42, a constant TA 33.5 or more.
    "ul_ta_vs_truth_ns": 0.15,
}

#: The channel state a CRC indication has to carry.
CHANNEL_STATE = ("ul_sinr_db", "timing_advance_ns")


def require_channel_state() -> None:
    """Raise unless the program's CRC indication (`fapi.indications`)
    carries the channel state the check compares."""
    try:
        crc = importlib.import_module(f"{PORT}.fapi.indications").CrcIndication
        fields = {f.name for f in dataclasses.fields(crc)}
    except (ImportError, AttributeError, TypeError):
        fields = set()
    missing = [name for name in CHANNEL_STATE if name not in fields]
    if missing:
        raise RuntimeError(
            "the program's CRC indication carries no channel state: it lacks "
            f"{', '.join(missing)} (the per-PUSCH UL SINR in dB and timing advance offset in "
            "ns of the CRC.indication), which this cell's check compares")


def channel(amplitude: float, nof_ports: int, nof_layers: int) -> np.ndarray:
    """(P, L) complex: amplitude exp(-2 pi j p l / P)."""
    return amplitude * np.exp(-2j * np.pi * np.outer(np.arange(nof_ports), np.arange(nof_layers))
                              / nof_ports)


def pusch_pdu(fapi, spec: dict, rnti: int, n_id: int):
    """One PUSCH PDU of the mix's shape as `fapi`'s class."""
    return fapi.PuschPdu(
        rnti=rnti, rb_start=spec["rb_start"], rb_size=spec["rb_size"],
        modulation=fapi.Modulation[spec["modulation"]],
        target_code_rate=spec["target_code_rate_x1024"] / 1024.0, rv=spec["rv"],
        nof_layers=spec["nof_layers"], start_symbol=spec["start_symbol"],
        nof_symbols=spec["nof_symbols"], dmrs_symbols=tuple(spec["dmrs_symbols"]), n_id=n_id)


def make_pool(traffic, config, seed, device, fapi) -> list[PoolSlot]:
    """`noise_std` lists one std per cell (cycled); the rows' RNTI, n_id,
    TB and delay, the noise and the first slot come from the seed."""
    require_channel_state()
    cell, ncell = config["cell"], config["nof_cells"]
    spec = traffic["pusch"]
    h = channel(traffic["channel_amplitude"], cell["nof_rx_ports"], spec["nof_layers"])
    noise = per_cell(traffic["noise_std"], ncell)
    rate = cell["dft_size"] * 15e3 * (1 << cell["numerology"])
    rng = np.random.default_rng(seed)
    first = int(rng.integers(traffic["first_slot"][0], traffic["first_slot"][1] + 1))
    nrows = traffic["pool_slots"] * ncell
    rntis = rng.integers(*traffic["rnti_range"], nrows).tolist()
    n_ids = rng.integers(*traffic["n_id_range"], nrows).tolist()
    lo, hi = traffic["delay_samples"]
    delays = rng.integers(lo, hi + 1, nrows).tolist()
    refs_all = [pusch_pdu(ref_pdus, spec, r, n) for r, n in zip(rntis, n_ids)]
    scrambling = ref_ul.gold_rows([(r << 15) + n for r, n in zip(rntis, n_ids)],
                                  ref_ul.codeword_bits(refs_all[0]))
    pool = []
    for k in range(traffic["pool_slots"]):
        slot = first + k
        reqs, samples, truth, refs = [], [], [], []
        for c in range(ncell):
            j = k * ncell + c
            rnti, n_id, delay, ref = rntis[j], n_ids[j], delays[j], refs_all[j]
            tb = rng.integers(0, 2, ref_ul.tbs(ref)).astype(np.uint8)
            samples.append(ref_ul.transmit(ref, tb, slot, cell, h, noise[c], delay, rng, device,
                                           scrambling[j]))
            reqs.append(fapi.UlTtiRequest(slot=slot, pusch=(pusch_pdu(fapi, spec, rnti, n_id),)))
            truth.append({"tb": tb, "ta_ns": delay / rate * 1e9,
                          "sinr_db": ref_ul.true_sinr_db(h, noise[c])})
            refs.append(ref)
        x = torch.from_numpy(np.stack(samples))
        if torch.device(device).type == "cuda":
            x = x.pin_memory()
        args = (reqs[0], x[0]) if ncell == 1 else (reqs, x)
        pool.append(PoolSlot(slot, args, truth, {"pdus": refs}))
    return pool


def per_cell_outputs(out, ncell: int) -> list[list]:
    """The entry's indications as one list per cell."""
    return [out] if ncell == 1 else list(out)


def crc_and_data(inds: list):
    """(the CRC indication, the RxData indication) of one cell's list, None
    where absent."""
    crc = next((x for x in inds if hasattr(x, "tb_crc_ok")), None)
    data = next((x for x in inds if hasattr(x, "tb_bits")), None)
    return crc, data


def reference_state(pool, i: int, config: dict, device, decode_sch: bool = False) -> list[dict]:
    """The reference receiver's outputs for every cell of pool slot i,
    computed once per pool slot (and once more with the decoder)."""
    key = "decoded" if decode_sch else "state"
    entry = pool[i]
    if key not in entry.ref:
        ncell = config["nof_cells"]
        samples = entry.args[1] if ncell > 1 else entry.args[1][None]
        entry.ref[key] = [
            ref_ul.receive(torch.as_tensor(samples[c], device=device), pdu, entry.slot,
                           config["cell"], decode_sch=decode_sch)
            for c, pdu in enumerate(entry.ref["pdus"])]
    return entry.ref[key]


class Cell:
    def __init__(self, traffic, config, pool, phy, device, seed):
        require_channel_state()
        self.config, self.pool, self.phy, self.device = config, pool, phy, device
        self.ncell = config["nof_cells"]
        self.rng = np.random.default_rng([seed, 1])
        self.reset()

    def call(self, i: int):
        req, samples = self.pool[i].args
        return self.phy.process_ul_slot(req, samples)

    def record(self, i: int, out) -> int:
        if out is None:
            self.failed += self.ncell
            return self.ncell
        cells = per_cell_outputs(out, self.ncell)
        bad = self.ncell if len(cells) != self.ncell else sum(
            1 for inds in cells if not getattr(crc_and_data(inds)[0], "tb_crc_ok", False))
        self.failed += bad
        self.seen[i] += 1
        if self.rng.random() * self.seen[i] < 1.0:  # one call per pool slot, uniformly
            self.kept[i] = cells
        return bad

    def reset(self) -> None:
        self.failed, self.seen, self.kept = 0, [0] * len(self.pool), {}

    def ldpc_work(self, i: int) -> tuple[int, int]:
        """(codeblocks, LDPC sweeps) of pool slot i's cell-slots: the sweeps
        the reference's layered decoder needs on its own LLRs of the same
        samples."""
        decoded = reference_state(self.pool, i, self.config, self.device, decode_sch=True)
        return (sum(len(d["sweeps"]) for d in decoded),
                sum(int(d["sweeps"].sum()) for d in decoded))

    def check(self) -> dict:
        """The kept outputs against the truth and the reference receiver."""
        wrong, worst = 0, dict.fromkeys(("sinr_ref", "sinr_truth", "ta_ref", "ta_truth"), 0.0)
        for i, cells in sorted(self.kept.items()):
            refs = reference_state(self.pool, i, self.config, self.device)
            for inds, truth, ref in zip(cells, self.pool[i].truth, refs):
                crc, data = crc_and_data(inds)
                tb = None if data is None else data.tb_bits
                if not (getattr(crc, "tb_crc_ok", False) and tb is not None
                        and np.array_equal(tb, truth["tb"])):
                    wrong += 1
                sinr = getattr(crc, "ul_sinr_db", None)
                ta = getattr(crc, "timing_advance_ns", None)
                for name, got, want in (("sinr_ref", sinr, ref["sinr_db"]),
                                        ("sinr_truth", sinr, truth["sinr_db"]),
                                        ("ta_ref", ta, ref["ta_ns"]),
                                        ("ta_truth", ta, truth["ta_ns"])):
                    err = math.inf if got is None else abs(float(got) - want)
                    worst[name] = max(worst[name], err if math.isfinite(err) else math.inf)
        return {"ul_calls_failed": self.failed, "ul_tb_wrong": wrong,
                "ul_sinr_vs_ref_db": worst["sinr_ref"], "ul_sinr_vs_truth_db": worst["sinr_truth"],
                "ul_ta_vs_ref_ns": worst["ta_ref"], "ul_ta_vs_truth_ns": worst["ta_truth"]}


# -------------------------------------------------------------- controls --


class Stale:
    """The program's indications of the call before (the first call's own)."""

    def __init__(self, phy):
        self.phy, self.prev = phy, None

    def process_ul_slot(self, requests, samples):
        out = self.phy.process_ul_slot(requests, samples)
        prev, self.prev = self.prev, out
        return out if prev is None else prev


class ConstantState:
    """The program's indications with one SINR and one TA in every CRC
    indication: the means of the pool's truths."""

    def __init__(self, phy, pool, ncell: int):
        self.phy, self.ncell = phy, ncell
        self.sinr = float(np.mean([t["sinr_db"] for e in pool for t in e.truth]))
        self.ta = float(np.mean([t["ta_ns"] for e in pool for t in e.truth]))

    def process_ul_slot(self, requests, samples):
        out = [[dataclasses.replace(x, ul_sinr_db=self.sinr, timing_advance_ns=self.ta)
                if hasattr(x, "ul_sinr_db") else x for x in inds]
               for inds in per_cell_outputs(self.phy.process_ul_slot(requests, samples),
                                            self.ncell)]
        return out[0] if self.ncell == 1 else out


@dataclass
class RefCrc:
    slot: int
    rnti: int
    tb_crc_ok: bool
    ul_sinr_db: float
    timing_advance_ns: float
    evm: float


@dataclass
class RefRxData:
    slot: int
    rnti: int
    tb_bits: np.ndarray | None


class Reference:
    """The reference receiver in the program's place, its grid stored at
    `precision`."""

    def __init__(self, pool, config, device, precision: str):
        self.by_request = {id(e.args[0]): e for e in pool}
        self.config, self.device, self.precision = config, device, precision

    def process_ul_slot(self, requests, samples):
        entry, ncell = self.by_request[id(requests)], self.config["nof_cells"]
        x = samples if ncell > 1 else samples[None]
        out = []
        for c, pdu in enumerate(entry.ref["pdus"]):
            r = ref_ul.receive(torch.as_tensor(x[c], device=self.device), pdu, entry.slot,
                               self.config["cell"], self.precision)
            out.append([RefCrc(entry.slot, pdu.rnti, r["tb_crc_ok"], r["sinr_db"], r["ta_ns"],
                               r["evm"]),
                        RefRxData(entry.slot, pdu.rnti, r["tb_bits"] if r["tb_crc_ok"] else None)])
        return out[0] if ncell == 1 else out


CONTROLS = {
    # Each call answered with the program's indications of the call before.
    "stale": lambda make_phy, pool, config, device: Stale(make_phy()),
    # One SINR and one TA for every cell and row.
    "constant_state": lambda make_phy, pool, config, device: ConstantState(
        make_phy(), pool, config["nof_cells"]),
    # The reference receiver with its grid in float8 e4m3, the precision
    # below the bfloat16 grid that the configuration states.
    "ref_fp8": lambda make_phy, pool, config, device: Reference(pool, config, device, "fp8"),
}
