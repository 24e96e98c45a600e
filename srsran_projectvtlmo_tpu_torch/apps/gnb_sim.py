"""Thin CLI driving the upper-PHY slot pipeline (the apps/gnb equivalent; the
port's counterpart of the repo's `apps/gnb_sim.py`).

Runs a configurable number of DL+UL slots through the full stack with a
loopback "radio": DL slots assemble SSB + PDCCH + PDSCH and OFDM-modulate;
UL slots carry a PUSCH from the built-in UE emulator through an optional TDL
channel into the PUSCH receiver. Prints per-slot results and summary metrics.
The gNB side runs on --device (the card by default); the emulated UE and
channel run in numpy on the host, as in the JAX app.

Usage:
  python -m srsran_projectvtlmo_tpu_torch.apps.gnb_sim --slots 4 --nof-rb 52 --dft 1024
  python -m srsran_projectvtlmo_tpu_torch.apps.gnb_sim --northstar --slots 8
  python -m srsran_projectvtlmo_tpu_torch.apps.gnb_sim --trace trace.json --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import sys
import time

import numpy as np
import torch

from ..fapi.pdus import (
    CrcIndication, CsiRsPdu, DlTtiRequest, PdcchPdu, PdschPdu, PrachPdu, PucchPdu, PuschPdu,
    RachIndication, SsbPdu, TxDataRequest, UciIndication, UlTtiRequest)
from ..models.channel import ChannelEmulator
from ..models.pusch_rx import PuschRxConfig
from ..models.sch_config import SchChainConfig
from ..models.ulsch_tx import cached_ulsch_tx
from ..ops import ofdm
from ..ops import prach as prach_mod
from ..ops.csi_rs import CsiRsConfig
from ..phy import pucch as pucch_mod
from ..phy.dl_slot import get_dl_slot_program
from ..phy.error_handler import UpperPhyErrorHandler
from ..phy.prach_buffer import PrachBuffer, PrachBufferFormat
from ..phy.realtime import SlotPipeline
from ..phy.rx_symbol_handler import RxSymbolFileDumper, RxSymbolHandler
from ..phy.upper_phy import CellConfig, ExpertPhyConfig, UpperPhy
from ..radio import FileIqSink
from ..ran.modulation import Modulation
from ..ran.re_pattern import csi_rs_patterns
from ..utils import tracing
from ..utils.cplx import np_to_pair, to_cplx
from ..utils.tables import resolve_device

#: The north-star carrier (BASELINE config 5): 273 PRB, DFT 4096 at 30 kHz.
NS_PRB, NS_DFT = 273, 4096


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--nof-rb", type=int, default=52)
    ap.add_argument("--dft", type=int, default=1024)
    ap.add_argument("--mcs-mod", default="16QAM")
    ap.add_argument("--code-rate", type=float, default=0.5)
    # Default 34: the north-star UL (QAM256 R=948/1024, 2 layers) has its
    # LDPC threshold at ~29 dB post-equalization; with ~1 dB channel-
    # estimation loss a 30 dB injected SNR sits exactly ON threshold and
    # CRC results flip with noise realizations -- 34 dB gives the validation
    # harness a real margin (a production cell would HARQ instead).
    ap.add_argument("--snr-db", type=float, default=34.0)
    ap.add_argument("--channel", default="AWGN", choices=["AWGN", "TDLA", "TDLB", "TDLC"])
    ap.add_argument("--config", default=None, help="YAML cell config (needs PyYAML)")
    ap.add_argument("--trace", default=None,
                    help="profile the slot loop with torch.profiler (the card's "
                         "activity too on --device cuda) and write its Chrome trace "
                         "here: spans app.dl_slot and app.ul_slot around the port's")
    ap.add_argument("--iq-out", default=None, help="record DL IQ to this file")
    ap.add_argument("--streaming", action="store_true",
                    help="feed UL symbol-by-symbol through the rx-symbol "
                         "handler (reference: upper_phy_rx_symbol_handler)")
    ap.add_argument("--pusch-rb", type=int, default=None,
                    help="PUSCH allocation size in RBs (default: min(16, cell "
                         "RBs) for quick runs; set to the carrier width for "
                         "full-band slots)")
    ap.add_argument("--northstar", action="store_true",
                    help="run the BASELINE north-star profile: 273 PRB, 4 TX/"
                         "RX ports, SSB+PDCCH+CSI-RS+2-layer precoded PDSCH "
                         "DL; 2-layer 272-PRB PUSCH + PUCCH F1 + periodic "
                         "PRACH UL through the streaming rx-symbol path and "
                         "the SlotPipeline (overrides the shape arguments)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the gNB side (default: the card)")
    return ap


def _expert(args) -> ExpertPhyConfig:
    if args.config:
        from ..utils.config import load_config

        return load_config(args.config).expert_phy
    return ExpertPhyConfig()


def _set_log_level(expert: ExpertPhyConfig) -> None:
    logging.basicConfig(level=getattr(logging, expert.log_level.upper(), logging.WARNING))


def _host_grid(grid_pair: torch.Tensor) -> np.ndarray:
    return to_cplx(grid_pair.float()).cpu().numpy()


def _profiler(path, device) -> contextlib.ExitStack:
    """An ExitStack holding `utils.tracing.profile` when `path` is set;
    closing it writes the trace."""
    stack = contextlib.ExitStack()
    if path:
        stack.enter_context(tracing.profile(path, device))
    return stack


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.northstar:
        return run_northstar(args)

    dev = resolve_device(args.device)
    if args.config:
        from ..utils.config import load_config

        gcfg = load_config(args.config)
        cell = gcfg.cells[0]
        expert = gcfg.expert_phy
    else:
        cell = CellConfig(nof_rb=args.nof_rb, dft_size=args.dft, numerology=1)
        expert = ExpertPhyConfig()
    _set_log_level(expert)

    mod = {m.value: m for m in Modulation}[args.mcs_mod]
    phy = UpperPhy(cell, expert, dev)
    sink = FileIqSink(args.iq_out) if args.iq_out else None

    pusch_rb = args.pusch_rb if args.pusch_rb else min(16, cell.nof_rb)
    if pusch_rb > cell.nof_rb:
        raise ValueError("--pusch-rb exceeds the carrier")
    ue_cfg = PuschRxConfig(
        nof_rb=pusch_rb, modulation=mod, target_code_rate=args.code_rate,
        rnti=0x4601, n_id=cell.phys_cell_id, dft_size=cell.dft_size,
        numerology=cell.numerology, dmrs_symbols=(2,),
    )

    pdsch = PdschPdu(rnti=0x4601, rb_start=0, rb_size=min(24, cell.nof_rb),
                     modulation=mod, target_code_rate=args.code_rate,
                     start_symbol=2, nof_symbols=12, dmrs_symbols=(4,),
                     n_id=cell.phys_cell_id)
    dl_sch = SchChainConfig(nof_rb=pdsch.rb_size, modulation=mod,
                            target_code_rate=args.code_rate, nof_ofdm_symbols=12,
                            dmrs_symbols=(2,), rnti=0x4601, n_id=cell.phys_cell_id,
                            start_symbol=2)

    rng = np.random.default_rng(0)
    crc_ok = 0
    tracer = _profiler(args.trace, dev)
    t_start = time.perf_counter()
    for slot in range(args.slots):
        with tracing.span("app.dl_slot"):
            tb = rng.integers(0, 2, dl_sch.tbs).astype(np.uint8)
            dl_req = DlTtiRequest(
                slot=slot,
                ssb=(SsbPdu(phys_cell_id=cell.phys_cell_id, ssb_block_index=0,
                            sfn=0, half_radio_frame=False),) if slot == 0 else (),
                pdsch=(pdsch,),
            )
            grid, samples = phy.process_dl_slot(dl_req, TxDataRequest(slot, [tb]))
            if sink:
                sink.transmit(samples)

        with tracing.span("app.ul_slot"):
            ue_cfg_slot = dataclasses.replace(ue_cfg, slot=slot)
            ul_tb = rng.integers(0, 2, ue_cfg_slot.tbs).astype(np.uint8)
            alloc_grid_pair, _ = cached_ulsch_tx(ue_cfg_slot, dev)(
                torch.as_tensor(ul_tb[None], device=dev))
            alloc = _host_grid(alloc_grid_pair[0])
            carrier = np.zeros((14, cell.nof_subc), np.complex64)
            carrier[:, : pusch_rb * 12] = alloc
            emu = ChannelEmulator(args.channel, args.snr_db, cell.nof_rx_ports,
                                  cell.nof_subc, 15e3 * (1 << cell.numerology), seed=slot)
            rx_grid, _ = emu.run(carrier)
            rx_samples = ofdm.ofdm_modulate(torch.as_tensor(np_to_pair(rx_grid), device=dev),
                                            cell.dft_size, cell.numerology,
                                            slot % (1 << cell.numerology))
            pusch_pdu = PuschPdu(rnti=0x4601, rb_start=0, rb_size=pusch_rb,
                                 modulation=mod, target_code_rate=args.code_rate,
                                 n_id=cell.phys_cell_id, dmrs_symbols=(2,))
            ul_req = UlTtiRequest(slot=slot, pusch=(pusch_pdu,))
            if args.streaming:
                # Symbol-streaming dispatch: demodulate the carrier once, then
                # feed the grid symbol by symbol; the PDU fires when its last
                # symbol arrives (reference:
                # upper_phy_rx_symbol_handler_impl.cpp:48-131).
                handler = RxSymbolHandler(cell.nof_rx_ports, cell.nof_subc)
                handler.repo.add(slot, pusch_pdu)
                full_grid = _host_grid(ofdm.ofdm_demodulate(
                    rx_samples, cell.nof_subc, cell.dft_size, cell.numerology,
                    slot % (1 << cell.numerology)))
                inds = []
                for sym in range(14):
                    ready = handler.handle_rx_symbol(slot, sym, full_grid[:, sym, :])
                    for pdu in ready:
                        req = UlTtiRequest(slot=slot, pusch=(pdu,))
                        inds.extend(phy.process_ul_slot(req, rx_samples, validate=False))
                handler.release_slot(slot)
            else:
                inds = phy.process_ul_slot(ul_req, rx_samples)
            for ind in inds:
                if isinstance(ind, CrcIndication):
                    crc_ok += int(ind.tb_crc_ok)
                    print(f"slot {slot}: PUSCH rnti=0x{ind.rnti:04x} "
                          f"crc={'OK' if ind.tb_crc_ok else 'KO'}")

    dt = time.perf_counter() - t_start
    print(f"\n{args.slots} slots in {dt:.2f}s ({args.slots / dt:.1f} slots/s); "
          f"UL CRC OK {crc_ok}/{args.slots}")
    if sink:
        sink.close()
    tracer.close()
    return 0 if crc_ok == args.slots else 1


def run_northstar(args) -> int:
    """The BASELINE config-5 cell profile end-to-end through the app:
    273-PRB 100 MHz-equivalent carrier, 4 TX/RX ports, DL = SSB + interleaved
    PDCCH + CSI-RS + 2-layer precoded full-band PDSCH (pipelined through
    SlotPipeline), UL = 2-layer 272-PRB QAM256 PUSCH (streaming rx-symbol
    dispatch) + PUCCH format 1 on the edge PRB + a PRACH occasion every 8
    slots (reference: apps/gnb/gnb.cpp +
    configs/gnb_ru_ran550_tdd_n78_100mhz_4x2.yml).  With --trace every slot
    count opens the spans app.dl_slot and app.ul_slot."""
    dev = resolve_device(args.device)
    cell = CellConfig(nof_rb=NS_PRB, dft_size=NS_DFT, numerology=1,
                      nof_tx_ports=4, nof_rx_ports=4, phys_cell_id=1)
    expert = _expert(args)
    _set_log_level(expert)
    phy = UpperPhy(cell, expert, dev)
    rng = np.random.default_rng(0)

    # --- DL: full-band 2-layer precoded PDSCH + PDCCH + CSI-RS (+SSB @0) ----
    w_dl = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2)) / 4) / 2.0
    prec = tuple(tuple((float(c.real), float(c.imag)) for c in row) for row in w_dl)
    # CSI-RS INSIDE the PDSCH span: the PDSCH rate-matches around it via the
    # reserved RE patterns (reference: pdsch_processor_impl.cpp:77-96).
    csi = CsiRsPdu(nof_rb=NS_PRB, symbol=12, subcarrier_offset=3)
    reserved = csi_rs_patterns(CsiRsConfig(
        nof_rb=NS_PRB, symbol=12, subcarrier_offset=3, slot=0))
    pdsch = PdschPdu(rnti=0x4601, rb_start=0, rb_size=NS_PRB,
                     modulation=Modulation.QAM256, target_code_rate=948 / 1024,
                     nof_layers=2, start_symbol=2, nof_symbols=11,
                     dmrs_symbols=(2,), n_id=cell.phys_cell_id, precoding=prec,
                     reserved=reserved)
    pdcch = PdcchPdu(rnti=0x4601, nof_dci_bits=40, aggregation_level=4,
                     cce_index=0, start_symbol=1, n_id=cell.phys_cell_id,
                     n_rnti=0x4601, coreset_nof_rb=48, interleaved=True)

    # --- UL: 272-PRB 2-layer PUSCH; PRB 272 carries PUCCH format 1 ---------
    pusch_rb = NS_PRB - 1
    ue_cfg = PuschRxConfig(
        nof_rb=pusch_rb, modulation=Modulation.QAM256,
        target_code_rate=948 / 1024, nof_layers=2, nof_rx_ports=4,
        rnti=0x4601, n_id=cell.phys_cell_id, dft_size=cell.dft_size,
        numerology=cell.numerology)
    mix = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2))
                 / 4).astype(np.complex64) / np.sqrt(4)
    noise_amp = 10.0 ** (-args.snr_db / 20.0)

    pucch_pdu = PucchPdu(format=1, rnti=0x4602, prb_start=pusch_rb, nof_prb=1,
                         start_symbol=0, nof_symbols=14,
                         initial_cyclic_shift=3, time_domain_occ=0,
                         nof_harq_bits=1, n_id=cell.phys_cell_id)
    prach_cfg = prach_mod.PrachDetectorConfig(
        sequence_length=prach_mod.LONG, root_sequence_index=0,
        zero_correlation_zone=1, ncs_table="1.25kHz")
    prach_fmt = PrachBufferFormat(sequence_length=prach_mod.LONG,
                                  nof_symbols=1, nof_ports=4)
    prach_pdu = PrachPdu(format_is_long=True, root_sequence_index=0,
                         zero_correlation_zone=1)

    err = UpperPhyErrorHandler(slot_duration_s=0.5e-3)
    pipeline = SlotPipeline(err, max_proc_delay_slots=expert.max_proc_delay_slots)
    sent_dl = []

    # Streaming rx-symbol handler shared across slots; with
    # expert_phy.rx_symbols_filename the completed UL slot grids append to a
    # binary IQ capture (reference: YAML phy_rx_symbols_filename).
    handler = RxSymbolHandler(cell.nof_rx_ports, cell.nof_subc)
    if expert.rx_symbols_filename:
        handler = RxSymbolFileDumper(handler, expert.rx_symbols_filename)

    crc_ok = 0
    pucch_ok = 0
    prach_expected = 0
    prach_found = 0
    tracer = _profiler(args.trace, dev)
    t_start = time.perf_counter()
    for count in range(args.slots):
        # The emulated radio repeats with period 8 (the TDD pattern length):
        # slot 0 carries the SSB and slot 4 the PRACH occasion.
        slot = count % 8
        # ---- DL slot, pipelined (unsynced device results in flight) -------
        with tracing.span("app.dl_slot"):
            dl_req = DlTtiRequest(
                slot=slot,
                ssb=(SsbPdu(phys_cell_id=cell.phys_cell_id, ssb_block_index=0,
                            sfn=0, half_radio_frame=False),) if slot == 0 else (),
                pdcch=(pdcch,), pdsch=(pdsch,), csi_rs=(csi,))
            tbs_dl = get_dl_slot_program(dl_req, cell, dev).pdsch_cfgs[0].tbs
            tb = rng.integers(0, 2, tbs_dl).astype(np.uint8)
            result = phy.process_dl_slot(dl_req, TxDataRequest(slot, [tb]), fetch=False)
            pipeline.submit(slot, result, on_done=lambda s, leaves: sent_dl.append(s))

        # ---- UL slot ------------------------------------------------------
        with tracing.span("app.ul_slot"):
            ue_slot = dataclasses.replace(ue_cfg, slot=slot)
            ul_tb = rng.integers(0, 2, ue_slot.tbs).astype(np.uint8)
            layer_grids, _ = cached_ulsch_tx(ue_slot, dev)(torch.as_tensor(ul_tb[None],
                                                                           device=dev))
            layers = _host_grid(layer_grids)[0]  # (L, 14, 12 * pusch_rb)
            carrier = np.einsum("pl,lsk->psk", mix, layers)  # (P, 14, 12 * pusch_rb)
            full = np.zeros((4, 14, cell.nof_subc), np.complex64)
            full[:, :, :pusch_rb * 12] = carrier
            # PUCCH F1 on the last PRB (1 HARQ bit = 1), visible at every port.
            f1 = pucch_mod.PucchFormat1Config(
                n_id=cell.phys_cell_id, slot=slot, start_symbol=0, nof_symbols=14,
                initial_cyclic_shift=3, time_domain_occ=0, nof_harq_bits=1)
            seqs, ((w_data, w_dmrs, _, _),) = pucch_mod._f1_tables(f1)
            d = (1 - 2 * 1) / np.sqrt(2) * (1 + 1j)
            i_data = i_dmrs = 0
            for s in range(14):
                if s % 2 == 0:
                    val = w_dmrs[i_dmrs] * seqs[s]
                    i_dmrs += 1
                else:
                    val = d * w_data[i_data] * seqs[s]
                    i_data += 1
                full[:, s, pusch_rb * 12:NS_PRB * 12] = val
            full += noise_amp * (rng.normal(size=full.shape)
                                 + 1j * rng.normal(size=full.shape)) / np.sqrt(2)
            rx_samples = ofdm.ofdm_modulate(torch.as_tensor(np_to_pair(full), device=dev),
                                            cell.dft_size, cell.numerology,
                                            slot % (1 << cell.numerology))

            pusch_pdu = PuschPdu(rnti=0x4601, rb_start=0, rb_size=pusch_rb,
                                 modulation=Modulation.QAM256,
                                 target_code_rate=948 / 1024, nof_layers=2,
                                 n_id=cell.phys_cell_id, dmrs_symbols=(2,))
            # Streaming rx-symbol dispatch for the PUSCH; PUCCH (+PRACH) ride
            # the same slot request.
            handler.repo.add(slot, pusch_pdu)
            inds = []
            for sym in range(14):
                ready = handler.handle_rx_symbol(slot, sym, full[:, sym, :])
                for pdu in ready:
                    inds.extend(phy.process_ul_slot(
                        UlTtiRequest(slot=slot, pusch=(pdu,)), rx_samples, validate=False))
            handler.release_slot(slot)

            prach_buf = None
            prach_req = ()
            if slot == 4:
                # PRACH occasion: preamble 7 through a per-port channel into
                # the occasion buffer.
                prach_expected += 1
                x = prach_mod.prach_generate(prach_cfg, preamble_index=7)
                buf = PrachBuffer(prach_fmt, 0)
                h = (rng.normal(size=4) + 1j * rng.normal(size=4)) / np.sqrt(2)
                occ = (h[:, None] * x[None, :]
                       + 0.05 * (rng.normal(size=(4, len(x)))
                                 + 1j * rng.normal(size=(4, len(x)))))
                buf.set_symbol(0, 0, np.stack([occ.real, occ.imag], -1))
                prach_buf = buf
                prach_req = (prach_pdu,)
            inds.extend(phy.process_ul_slot(
                UlTtiRequest(slot=slot, pucch=(pucch_pdu,), prach=prach_req),
                rx_samples, prach_samples=prach_buf, validate=False))

            for ind in inds:
                if isinstance(ind, CrcIndication):
                    crc_ok += int(ind.tb_crc_ok)
                    print(f"slot {count}: PUSCH rnti=0x{ind.rnti:04x} "
                          f"crc={'OK' if ind.tb_crc_ok else 'KO'}", flush=True)
                elif isinstance(ind, UciIndication):
                    ok = bool(ind.valid) and \
                        np.asarray(ind.harq_bits).ravel()[:1].tolist() == [1]
                    pucch_ok += int(ok)
                elif isinstance(ind, RachIndication):
                    pres = [int(p[0]) for p in ind.preambles]
                    if 7 in pres:
                        prach_found += 1
                    print(f"slot {slot}: PRACH preambles={pres}", flush=True)

    pipeline.flush()
    if expert.rx_symbols_filename:
        handler.close()
        print(f"rx symbols: {handler.nof_slots_written} slot grids -> "
              f"{expert.rx_symbols_filename} "
              f"({handler.nof_dropped_writes} dropped)", flush=True)
    dt = time.perf_counter() - t_start
    tracer.close()
    print(f"\nnorthstar: {args.slots} DL+UL slots in {dt:.2f}s "
          f"({args.slots / dt:.2f} slots/s incl host); "
          f"UL CRC OK {crc_ok}/{args.slots}, PUCCH F1 {pucch_ok}/{args.slots},"
          f" PRACH {prach_found}/{prach_expected}, DL pipelined "
          f"{len(sent_dl)}/{args.slots}, late {err.stats.late_ul}", flush=True)
    ok = (crc_ok == args.slots and pucch_ok == args.slots
          and prach_found == prach_expected and len(sent_dl) == args.slots)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
