"""PyTorch port, the app and its host modules against the JAX package: the
simulator app (`apps/gnb_sim`), the entry module (`entry`), `utils/config`,
`utils/log`, `ran/mcs`, `phy/rx_symbol_handler`, and the `ExpertPhyConfig`
fields the app reads; and the app's `--trace`, a torch.profiler trace.

The JAX app runs once, in a subprocess (`python apps/gnb_sim.py`, its own
compile cache in a temporary directory), which also keeps the known native
XLA:CPU crash away from the test worker; the port's app runs in this
process.  JAX is imported inside the tests only, so the gloo ranks of the
multi-device dry run (`dryrun_rank`) never load it.

Tolerances and why:
  * app lines, CRC flags, config fields, hex text, MCS entries, ready PDUs,
    capture bytes: equal;
  * `entry()`'s snr_db on its noise example: 1e-3 dB absolute (float32
    estimates from XLA and torch sum in another order);
  * the dry run's sharded demodulation against `ops.ofdm.ofdm_demodulate`:
    rtol 1e-4, atol 1e-5, as tests/test_parallel.py.
"""

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu_torch import entry
from srsran_projectvtlmo_tpu_torch.apps import gnb_sim
from srsran_projectvtlmo_tpu_torch.ops import ofdm
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, ExpertPhyConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The app's parity run: 2 slots of a 24-PRB cell at DFT 512.
APP_ARGS = ["--slots", "2", "--nof-rb", "24", "--dft", "512"]
_PUSCH_LINE = re.compile(r"^slot \d+: PUSCH rnti=0x[0-9a-f]{4} crc=(OK|KO)$", re.M)
_CRC_COUNT = re.compile(r"UL CRC OK (\d+)/(\d+)")


@pytest.fixture(scope="module")
def jax_app(tmp_path_factory):
    """(exit code, standard output) of the JAX app on APP_ARGS."""
    cache = tmp_path_factory.mktemp("jax_cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache))
    res = subprocess.run([sys.executable, os.path.join(REPO, "apps", "gnb_sim.py"), *APP_ARGS],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    return res.returncode, res.stdout


@pytest.mark.parametrize("streaming", [False, True])
def test_app_default_profile_matches_jax(jax_app, capsys, streaming):
    """The same per-slot PUSCH lines, CRC count and exit code as the JAX app,
    with the whole slot dispatched at once and symbol by symbol."""
    rc_jax, out_jax = jax_app
    rc = gnb_sim.main(APP_ARGS + ["--device", "cpu"] + (["--streaming"] if streaming else []))
    out = capsys.readouterr().out
    assert rc == rc_jax == 0, out_jax
    lines = [m.group(0) for m in _PUSCH_LINE.finditer(out)]
    assert lines == [m.group(0) for m in _PUSCH_LINE.finditer(out_jax)]
    assert len(lines) == 2
    assert _CRC_COUNT.search(out).groups() == _CRC_COUNT.search(out_jax).groups() == ("2", "2")


def test_app_trace_and_iq_capture(tmp_path, capsys):
    """--trace writes torch.profiler's Chrome trace: per slot the spans
    app.dl_slot and app.ul_slot, in order, with the port's entry spans nested
    inside them on the same clock; and --iq-out the DL samples that
    `radio.FileIqSource` reads back."""
    from srsran_projectvtlmo_tpu_torch.radio import FileIqSource

    trace, iq = tmp_path / "t.json", tmp_path / "dl.iq"
    assert gnb_sim.main(APP_ARGS + ["--device", "cpu", "--trace", str(trace),
                                    "--iq-out", str(iq)]) == 0
    assert not torch.autograd._profiler_enabled()
    events = json.loads(trace.read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"), key=lambda x: x[1])
    slots = [s for s in spans if s[0].startswith("app.")]
    assert [name for name, _, _ in slots] == ["app.dl_slot", "app.ul_slot"] * 2
    inner = [("upper_phy.process_dl_slot", "dl_slot.run"),
             ("upper_phy.process_ul_slot", "upper_phy.ul_ofdm")] * 2
    for (outer, s0, e0), (entry_span, leaf) in zip(slots, inner):
        nested = [n for n, s, e in spans if s0 <= s and e <= e0 and n != outer]
        assert nested.count(entry_span) == 1 and leaf in nested, (outer, nested)
    nsamp = ofdm.slot_sample_count(512, 1, 0) + ofdm.slot_sample_count(512, 1, 1)
    assert iq.stat().st_size == nsamp * 8
    assert np.isfinite(FileIqSource(iq).receive(nsamp)).all()


def test_northstar_profile_reads_the_expert_config(tmp_path, capsys, monkeypatch):
    """The north-star profile on a 52-PRB carrier (the CORESET needs 48 RB)
    for 5 slots -- the SSB at slot 0, the PRACH occasion at slot 4 -- with a
    YAML expert config: its max_proc_delay_slots sizes the DL pipeline, its
    log_level sets the log level, and its rx_symbols_filename captures every
    UL slot grid."""
    monkeypatch.setattr(gnb_sim, "NS_PRB", 52)
    monkeypatch.setattr(gnb_sim, "NS_DFT", 1024)
    capture = tmp_path / "rx.bin"
    cfg = tmp_path / "gnb.yml"
    cfg.write_text(f"expert_phy:\n  max_proc_delay_slots: 1\n  log_level: error\n"
                   f"  rx_symbols_filename: {capture}\n")
    depths = []
    real_submit = gnb_sim.SlotPipeline.submit

    def submit(self, slot, result, on_done=None):
        real_submit(self, slot, result, on_done)
        depths.append(self.nof_in_flight)

    monkeypatch.setattr(gnb_sim.SlotPipeline, "submit", submit)
    rc = gnb_sim.main(["--northstar", "--slots", "5", "--device", "cpu", "--config", str(cfg)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "UL CRC OK 5/5, PUCCH F1 5/5, PRACH 1/1, DL pipelined 5/5" in out
    assert "slot 4: PRACH preambles=[7]" in out
    assert depths == [1] * 5
    assert capture.stat().st_size == 5 * 4 * 14 * 52 * 12 * 8
    assert f"rx symbols: 5 slot grids -> {capture} (0 dropped)" in out


def test_slot_pipeline_syncs_a_bf16_grid():
    """The DL slot's bf16 grid drains from the pipeline (numpy has no
    bfloat16: it comes back as float32 with the same values)."""
    from srsran_projectvtlmo_tpu_torch.phy.realtime import SlotPipeline

    grid = torch.tensor([[1.5, -0.25], [3.0, 0.0078125]], dtype=torch.bfloat16)
    got = SlotPipeline._default_sync((grid, torch.ones(2)))
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], grid.float().numpy())


# --------------------------------------------------------- host modules --

def test_load_config_matches_jax(tmp_path):
    """One YAML setting every field of the port's CellConfig and
    ExpertPhyConfig: both loaders give the same values (the JAX configs'
    `use_pallas_decoder` and `coreset_rb_start` have no port counterpart)."""
    from srsran_projectvtlmo_tpu.utils.config import load_config as jax_load
    from srsran_projectvtlmo_tpu_torch.utils.config import GnbConfig, load_config

    p = tmp_path / "gnb.yml"
    p.write_text("cells:\n"
                 "  - {nof_rb: 106, dft_size: 2048, numerology: 1, nof_tx_ports: 2,\n"
                 "     nof_rx_ports: 4, phys_cell_id: 7, ssb_subc_offset: 12, grid_bf16: false}\n"
                 "  - {nof_rb: 52}\n"
                 "expert_phy: {pusch_decoder_max_iterations: 8, max_proc_delay_slots: 3,\n"
                 "             log_level: info, rx_symbols_filename: rx.bin}\n")
    ours, theirs = load_config(p), jax_load(p)
    assert len(ours.cells) == len(theirs.cells) == 2
    for a, b in zip(ours.cells, theirs.cells):
        want = dataclasses.asdict(b)
        del want["coreset_rb_start"]
        assert dataclasses.asdict(a) == want
    want = dataclasses.asdict(theirs.expert_phy)
    del want["use_pallas_decoder"]
    assert dataclasses.asdict(ours.expert_phy) == want
    assert dataclasses.asdict(ExpertPhyConfig()) == {
        k: v for k, v in dataclasses.asdict(type(theirs.expert_phy)()).items()
        if k != "use_pallas_decoder"}
    assert dataclasses.asdict(GnbConfig()) == {
        "cells": [dataclasses.asdict(CellConfig())],
        "expert_phy": dataclasses.asdict(ExpertPhyConfig())}
    p.write_text("expert_phy: {use_pallas_decoder: true}\n")
    with pytest.raises(ValueError, match="unknown ExpertPhyConfig field"):
        load_config(p)


def test_log_matches_jax():
    """hex_dump renders the same text; init_logging configures the same
    module loggers, whose records reach the stream."""
    from srsran_projectvtlmo_tpu.utils import log as jax_log
    from srsran_projectvtlmo_tpu_torch.utils import log

    rng = np.random.default_rng(5)
    inputs = [rng.integers(0, 256, 100).astype(np.uint8), rng.integers(0, 2, 40).astype(np.uint8),
              rng.normal(size=(3, 2)).astype(np.float32), np.arange(10, dtype=np.int16)]
    for data in inputs:
        for size in (None, 4, 1000):
            assert log.hex_dump(data, size) == jax_log.hex_dump(data, size)
    stream = io.StringIO()
    log.init_logging({"PHY": "debug", "all": "error"}, stream=stream)
    levels = {m: log.get_logger(m).level for m in log._MODULES}
    log.get_logger("OFH").warning("dropped")
    log.get_logger("PHY").debug("slot %d", 7)
    deadline = time.monotonic() + 10.0  # the listener thread writes the records
    while "slot 7" not in stream.getvalue() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert log._MODULES == jax_log._MODULES
    assert levels == {m: (10 if m == "PHY" else 40) for m in log._MODULES}
    assert "[srsran_tpu.PHY] [D] slot 7" in stream.getvalue()
    assert "dropped" not in stream.getvalue()


def test_mcs_tables_match_jax():
    from srsran_projectvtlmo_tpu.ran import mcs as jax_mcs
    from srsran_projectvtlmo_tpu_torch.ran import mcs

    for table, n in (("qam64", 29), ("qam256", 28)):
        for i in range(n):
            m, r = mcs.mcs_to_modulation_and_rate(i, table)
            jm, jr = jax_mcs.mcs_to_modulation_and_rate(i, table)
            assert (m.value, r) == (jm.value, jr), (table, i)
        for bad in (-1, n):
            with pytest.raises(ValueError):
                mcs.mcs_to_modulation_and_rate(bad, table)


def test_rx_symbol_handler_matches_jax(tmp_path):
    """PDUs of different symbol windows in two slots: the same ready PDUs
    at each symbol, the same pending counts, and the dumper's capture
    byte for byte (ports 1-2 of 3, complex64, slot after slot)."""
    from srsran_projectvtlmo_tpu.fapi.pdus import PuschPdu as JaxPusch
    from srsran_projectvtlmo_tpu.phy import rx_symbol_handler as jax_rsh
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation as JaxMod
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import PuschPdu
    from srsran_projectvtlmo_tpu_torch.phy import rx_symbol_handler as rsh
    from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation

    windows = [(0, 14), (2, 6), (5, 9), (0, 13)]

    def run(mod, pdu_cls, qam, path):
        handler = mod.RxSymbolFileDumper(mod.RxSymbolHandler(3, 24), str(path), ports=(1, 3))
        rng = np.random.default_rng(9)
        seen = []
        for slot in (3, 4):
            for i, (s0, n) in enumerate(windows):
                handler.repo.add(slot, pdu_cls(rnti=i, rb_start=0, rb_size=2, modulation=qam,
                                               target_code_rate=0.5, start_symbol=s0,
                                               nof_symbols=n))
            g = (rng.normal(size=(3, 14, 24)) + 1j * rng.normal(size=(3, 14, 24)))
            for sym in range(14):
                ready = handler.handle_rx_symbol(slot, sym, g[:, sym].astype(np.complex64))
                seen.append((slot, sym, [p.rnti for p in ready],
                             handler.repo.nof_pending(slot)))
            np.testing.assert_array_equal(handler.grid(slot), g.astype(np.complex64))
            handler.release_slot(slot)
        handler.close()
        return seen, handler.nof_slots_written, path.read_bytes()

    ours = run(rsh, PuschPdu, Modulation.QAM16, tmp_path / "a.bin")
    theirs = run(jax_rsh, JaxPusch, JaxMod.QAM16, tmp_path / "b.bin")
    assert ours == theirs
    assert ours[1] == 2 and len(ours[2]) == 2 * 2 * 14 * 24 * 8


# --------------------------------------------------------------- entry --

def test_entry_matches_jax(monkeypatch):
    """entry(device="cpu") against the JAX entry() on the same samples, the
    port's receiver with the JAX package's noise estimate."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as jax_entry

    own = entry.entry_config
    monkeypatch.setattr(entry, "entry_config",
                        lambda: dataclasses.replace(own(), unbiased_noise=False))
    fn, (samples,) = entry.entry(device="cpu")
    jfn, (jsamples,) = jax_entry.entry()
    np.testing.assert_array_equal(samples.numpy(), np.asarray(jsamples))
    ok, snr = fn(samples)
    jok, jsnr = jfn(jsamples)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(snr.numpy(), np.asarray(jsnr), rtol=0, atol=1e-3)
    assert ok.shape == (2,) and snr.shape == (2,)


#: The dry run's carrier on the CPU: 24 PRB at DFT 512 (the north-star
#: 273 PRB at DFT 4096 runs on the card, chip_smoke.py phase 23).
DRYRUN_SHAPE = (24, 512)


def dryrun_rank(world: int, payload) -> dict:
    """One rank of `entry.dryrun_multichip(world)` on the CPU at DRYRUN_SHAPE:
    what the checks need, as numpy."""
    entry.NS_PRB, entry.NS_DFT = DRYRUN_SHAPE
    res = entry.dryrun_multichip(world, device="cpu")
    cfg = res["cfg"]
    want = ofdm.ofdm_demodulate(res["samples"], cfg.nof_subc, cfg.dft_size, 1, 0)
    return {"tb_crc_ok": res["rx"]["tb_crc_ok"].numpy(),
            "fir_err": float((res["filtered"] - res["padded"]).abs().max()),
            "demod_ok": bool(torch.allclose(res["grid"], want, rtol=1e-4, atol=1e-5)),
            "hard_equal": bool((res["hard_cb"].numpy() == res["info_cb"]).all()),
            "ncells": res["tb"].shape[0]}


@pytest.mark.parametrize("world", [1, 4])
def test_dryrun_multichip(world, monkeypatch, capsys):
    """The dry run at world 1 (no process group) and over 4 gloo ranks as a
    (2 cell x 2 sp) mesh, which also runs the batched multi-cell DL: every
    cell decodes, the identity FIR is exact, the sharded demodulation equals
    the unsharded one, and the CB-sharded decode returns the info bits."""
    if world == 1:
        monkeypatch.setattr(entry, "NS_PRB", DRYRUN_SHAPE[0])
        monkeypatch.setattr(entry, "NS_DFT", DRYRUN_SHAPE[1])
        results = [dryrun_rank(1, None)]
        assert "dryrun_multichip: 1 devices as (1 cell x 1 sp) mesh" in capsys.readouterr().out
    else:
        from tests.test_torch_parallel import run_ranks

        results = run_ranks(world, "tests.test_torch_app:dryrun_rank", None)
    for r in results:
        assert r["ncells"] == (2 if world == 4 else 1)
        assert r["tb_crc_ok"].all() and r["tb_crc_ok"].shape == (r["ncells"],)
        assert r["fir_err"] == 0.0 and r["demod_ok"] and r["hard_equal"]
