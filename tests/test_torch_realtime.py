"""PyTorch port, the realtime slot machinery and the host modules around the
uplink entry point, against the JAX package: `phy/realtime` (the cases of
tests/test_realtime.py), `phy/error_handler`, `phy/prach_buffer` (the cases
of tests/test_prach_buffer.py) and `phy/warmup.precompile_pusch`.

Threads and queues are plain Python in both packages; the device work they
drive is the port's `UpperPhy` on the CPU, held against the JAX `UpperPhy` on
the same samples (`tests/test_torch_upper_phy.compare`: bits and flags equal).
"""

import dataclasses
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig as JaxPuschRxConfig
from srsran_projectvtlmo_tpu.ops import prach as jax_prach
from srsran_projectvtlmo_tpu.phy import error_handler as jax_error_handler
from srsran_projectvtlmo_tpu.phy import realtime as jax_realtime
from srsran_projectvtlmo_tpu.phy import upper_phy as jax_upper_phy
from srsran_projectvtlmo_tpu.phy import warmup as jax_warmup
from srsran_projectvtlmo_tpu.ran.modulation import Modulation as JaxModulation

from srsran_projectvtlmo_tpu_torch.fapi.pdus import (
    CrcIndication, DlTtiRequest, PdschPdu, PuschPdu, RxDataIndication, TxDataRequest,
    UlTtiRequest)
from srsran_projectvtlmo_tpu_torch.models.pusch_rx import (
    PuschRxConfig, cached_pusch_rx, cached_pusch_rx_from_grid, flatten_tb_bits)
from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import cached_ulsch_tx
from srsran_projectvtlmo_tpu_torch.ops import prach
from srsran_projectvtlmo_tpu_torch.phy.dl_slot import get_dl_slot_program
from srsran_projectvtlmo_tpu_torch.phy.error_handler import UpperPhyErrorHandler
from srsran_projectvtlmo_tpu_torch.phy.prach_buffer import (
    PrachBuffer, PrachBufferFormat, PrachBufferPool)
from srsran_projectvtlmo_tpu_torch.phy.realtime import (
    BasebandChain, LowerPhyRealtime, PrachOccasionCollector, SlotPipeline)
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu_torch.phy.warmup import precompile_pusch, slots_per_frame
from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation
from tests.test_torch_parallel import run_isolated
from tests.test_torch_upper_phy import compare, pusch_slot, to_jax


# ------------------------------------------------------------ slot pipeline --

class TestSlotPipeline:
    def test_window_bound_and_order(self):
        drained = []
        p = SlotPipeline(UpperPhyErrorHandler(slot_duration_s=10.0), max_proc_delay_slots=2,
                         sync=lambda r: r)
        for s in range(5):
            p.submit(s, f"r{s}", on_done=lambda slot, res: drained.append(slot))
            assert p.nof_in_flight <= 2
        p.flush()
        assert drained == [0, 1, 2, 3, 4]
        assert p.nof_in_flight == 0

    def test_late_slot_recorded(self):
        events = []
        eh = UpperPhyErrorHandler(slot_duration_s=1e-9,
                                  on_error=lambda k, s, l: events.append((k, s)))
        p = SlotPipeline(eh, max_proc_delay_slots=1, sync=lambda r: time.sleep(0.002) or r)
        p.submit(0, "a")
        p.submit(1, "b")
        p.flush()
        assert ("late_pipeline", 0) in events and eh.stats.late_ul == 2

    def test_default_sync_copies_tensors_to_the_host_in_tree_order(self):
        """The default sync walks dicts (by key), lists and tuples, drops
        None, and returns the leaves as numpy, as the JAX pipeline's pytree
        walk does."""
        rng = np.random.default_rng(0)
        tree = {"b": [rng.normal(size=3).astype(np.float32), None],
                "a": (np.arange(4, dtype=np.int8), {"z": np.uint8(3), "y": 2.5})}
        as_torch = {"b": [torch.as_tensor(tree["b"][0]), None],
                    "a": (torch.as_tensor(tree["a"][0]), {"z": torch.tensor(3, dtype=torch.uint8),
                                                         "y": 2.5})}
        as_jax = {"b": [jnp.asarray(tree["b"][0]), None],
                  "a": (jnp.asarray(tree["a"][0]), {"z": jnp.uint8(3), "y": 2.5})}
        got = SlotPipeline._default_sync(as_torch)
        want = jax_realtime.SlotPipeline._default_sync(as_jax)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    def test_drains_ul_indications_of_the_upper_phy(self):
        """Slots of the port's UpperPhy through a two-deep window: each slot's
        CRC verdict reaches its callback in slot order."""
        phy = UpperPhy(CellConfig(nof_rb=24, dft_size=512, numerology=1), device="cpu")
        pdu = PuschPdu(rnti=0x4601, rb_start=4, rb_size=16, modulation=Modulation.QAM16,
                       target_code_rate=0.5, n_id=3, dmrs_symbols=(2, 11))
        got = []
        p = SlotPipeline(UpperPhyErrorHandler(slot_duration_s=60.0), max_proc_delay_slots=2,
                         sync=lambda inds: inds)
        for slot in (3, 5, 7):
            samples, _ = pusch_slot(pdu, slot, 1, seed=70 + slot)
            inds = phy.process_ul_slot(UlTtiRequest(slot=slot, pusch=(pdu,)), samples)
            p.submit(slot, inds, on_done=lambda s, r: got.append((s, r[0].tb_crc_ok)))
        p.flush()
        assert got == [(3, True), (5, True), (7, True)]


# --------------------------------------------------------- baseband chains --

class TestBasebandChain:
    def test_self_requeue_and_throttle(self):
        def work(x):
            time.sleep(0.005)
            return x * 2

        ch = BasebandChain("t", work, queue_depth=2)
        ch.start()
        t0 = time.perf_counter()
        for i in range(6):
            ch.enqueue(i)
        # With depth 2 the producer was throttled.
        assert time.perf_counter() - t0 > 0.01
        assert sorted(ch.wait_result(timeout=1.0)[1] for _ in range(6)) == [0, 2, 4, 6, 8, 10]
        ch.stop()
        assert not ch._thread.is_alive()

    def test_exception_surfaced(self):
        def bad(x):
            raise ValueError("boom")

        ch = BasebandChain("t2", bad, queue_depth=1)
        ch.start()
        ch.enqueue(1)
        _, res = ch.wait_result(timeout=1.0)
        assert isinstance(res, ValueError)
        ch.stop()
        assert not ch._thread.is_alive()


class _LoopbackGateway:
    def __init__(self):
        self.tx = []
        self.rx_buf = None

    def transmit(self, samples):
        self.tx.append(np.asarray(samples))

    def receive(self, n):
        return self.rx_buf


def jax_dl_ul_reference(payload):
    """The JAX UpperPhy's DL samples and UL indications for
    `test_dl_ul_chains_end_to_end`, computed in a fresh interpreter
    (`run_isolated`): a long-lived worker can die of the known native
    XLA:CPU crash inside these compiles."""
    cell, dl_request, tx_data, request, samples = payload
    jphy = jax_upper_phy.UpperPhy(to_jax(cell))
    _, want = jphy.process_dl_slot(to_jax(dl_request), to_jax(tx_data))
    return np.asarray(want), jphy.process_ul_slot(to_jax(request), samples)


class TestLowerPhyRealtime:
    def test_dl_ul_chains_end_to_end(self):
        """The DL chain hands the port's DL slot to the gateway, the JAX
        UpperPhy's samples within 1e-5 relative RMS; the UL chain decodes a
        PUSCH slot, with the JAX UpperPhy's indications."""
        cell = CellConfig(nof_rb=24, dft_size=512, numerology=1)
        phy = UpperPhy(cell, device="cpu")
        gw = _LoopbackGateway()
        eh = UpperPhyErrorHandler(slot_duration_s=60.0)
        rt = LowerPhyRealtime(phy, gw, eh, queue_depth=2)
        dl_pdu = PdschPdu(rnti=0x21, rb_start=2, rb_size=20, modulation=Modulation.QAM16,
                          target_code_rate=0.5, n_id=1)
        dl_request = DlTtiRequest(slot=0, pdsch=(dl_pdu,))
        tbs = get_dl_slot_program(dl_request, cell, "cpu").pdsch_cfgs[0].tbs
        tx_data = TxDataRequest(slot=0, tb_bits=[
            np.random.default_rng(5).integers(0, 2, tbs).astype(np.uint8)])
        rt.start()
        try:
            rt.dl.enqueue((dl_request, tx_data))
            _, shape = rt.dl.wait_result(timeout=60.0)

            pdu = PuschPdu(rnti=0x21, rb_start=4, rb_size=16, modulation=Modulation.QAM16,
                           target_code_rate=0.5, n_id=1, dmrs_symbols=(2, 11))
            gw.rx_buf, tb = pusch_slot(pdu, 1, 1, seed=71)
            request = UlTtiRequest(slot=1, pusch=(pdu,))
            rt.ul.enqueue((request, None, None))
            _, inds = rt.ul.wait_result(timeout=120.0)
        finally:
            rt.stop()
        assert not isinstance(shape, Exception), shape
        want, jinds = run_isolated("tests.test_torch_realtime:jax_dl_ul_reference",
                                   (cell, dl_request, tx_data, request, gw.rx_buf))
        assert len(gw.tx) == 1 and shape == gw.tx[0].shape == want.shape
        err = np.sqrt(np.mean((gw.tx[0] - want) ** 2) / np.mean(want ** 2))
        assert err < 1e-5, err

        assert not isinstance(inds, Exception), inds
        assert [i for i in inds if isinstance(i, CrcIndication)][0].tb_crc_ok
        np.testing.assert_array_equal([i for i in inds if isinstance(i, RxDataIndication)][0]
                                      .tb_bits, tb)
        compare(jinds, inds)
        assert eh.stats.late_dl == 0 and eh.stats.late_ul == 0
        assert not rt.dl._thread.is_alive() and not rt.ul._thread.is_alive()


class TestPrachCollector:
    def test_window_state_machine(self):
        c = PrachOccasionCollector()
        c.configure(slot=4, start_symbol=2, nof_symbols=3)
        assert c.state == c.WAIT
        assert c.on_symbol(4, 0, np.zeros(8)) is None  # before window
        assert c.on_symbol(3, 2, np.zeros(8)) is None  # wrong slot
        assert c.on_symbol(4, 2, np.ones(8)) is None
        assert c.state == c.COLLECTING
        assert c.on_symbol(4, 3, np.ones(8)) is None
        win = c.on_symbol(4, 4, np.ones(8))
        assert win is not None and win.shape == (3, 8) and c.state == c.READY
        # The collector resets after surrendering the window.
        assert c.on_symbol(4, 2, np.ones(8)) is None


# ----------------------------------------------------------- error handler --

def test_error_handler_counts_as_jax():
    events, jevents = [], []
    eh = UpperPhyErrorHandler(0.5e-3, on_error=lambda k, s, l: events.append((k, s)))
    jeh = jax_error_handler.UpperPhyErrorHandler(
        0.5e-3, on_error=lambda k, s, l: jevents.append((k, s)))
    now = time.perf_counter()
    for h in (eh, jeh):
        assert not h.check_dl_deadline(1, now - 1.0)
        assert h.check_dl_deadline(2, time.perf_counter() + 10.0)
        assert not h.check_ul_deadline(3, now - 1.0)
        h.on_failure(4, RuntimeError("x"))
    assert events == jevents == [("late_dl", 1), ("late_ul", 3), ("failed", 4)]
    assert vars(eh.stats) == vars(jeh.stats) == {"late_dl": 1, "late_ul": 1, "failed": 1}


# ------------------------------------------------------------- PRACH buffer --

def test_pool_reserve_release_cycle():
    pool = PrachBufferPool(PrachBufferFormat(sequence_length=139, nof_symbols=2, nof_ports=2),
                           nof_buffers=2)
    a, b = pool.reserve(slot=10), pool.reserve(slot=11)
    assert a is not None and b is not None and a.index != b.index
    assert pool.reserve(slot=12) is None  # exhausted -> dropped occasion
    pool.release(a)
    assert pool.nof_free == 1
    c = pool.reserve(slot=13)
    assert c is not None and c.slot == 13 and not c.full
    pool.release(b)
    with pytest.raises(ValueError):
        pool.release(b)


def test_pool_under_contention():
    """Eight threads reserve and release one pool's buffers with a short
    switch interval: no buffer is ever held twice, and all come back."""
    pool = PrachBufferPool(PrachBufferFormat(sequence_length=139), nof_buffers=3)
    held, clash, lock = set(), [], threading.Lock()

    def worker():
        for i in range(300):
            buf = pool.reserve(slot=i)
            if buf is None:
                continue
            with lock:
                if buf.index in held:
                    clash.append(buf.index)
                held.add(buf.index)
            with lock:
                held.discard(buf.index)
            pool.release(buf)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not clash and pool.nof_free == 3


def test_buffer_fill_tracking_and_views():
    buf = PrachBuffer(PrachBufferFormat(sequence_length=139, nof_symbols=2, nof_ports=2), 0)
    s0 = np.random.default_rng(0).normal(size=(2, 139, 2)).astype(np.float32)
    buf.set_symbol(0, 0, s0)
    assert not buf.full
    buf.set_symbol(0, 1, s0 * 2)
    assert buf.full
    occ = buf.occasion(0)
    assert occ.shape == (2, 2, 139, 2)
    np.testing.assert_array_equal(occ[0], s0)
    with pytest.raises(ValueError):
        buf.set_symbol(0, 0, s0[0])  # one port's data for a 2-port buffer
    buf.reset()
    assert not buf.full and not occ.any()


def test_collector_to_buffer_to_detector():
    """Lower-PHY symbol stream -> PrachBuffer -> multi-port detection, with
    the JAX detector's preambles on the same occasion."""
    kw = dict(sequence_length=prach.SHORT, root_sequence_index=1, zero_correlation_zone=1,
              ncs_table="short")
    cfg = prach.PrachDetectorConfig(**kw)
    pre = prach.prach_generate(cfg, preamble_index=7)
    nof_ports, nof_symbols = 2, 2
    pool = PrachBufferPool(PrachBufferFormat(sequence_length=139, nof_symbols=nof_symbols,
                                             nof_ports=nof_ports))
    buf = pool.reserve(slot=4)
    rng = np.random.default_rng(1)
    phases = np.exp(1j * rng.uniform(0, 2 * np.pi, nof_ports))
    for p in range(nof_ports):
        col = PrachOccasionCollector()
        col.configure(slot=4, start_symbol=0, nof_symbols=nof_symbols)
        for s in range(nof_symbols):
            c = pre * phases[p] + 0.05 * (rng.normal(size=139) + 1j * rng.normal(size=139))
            win = col.on_symbol(4, s, np.stack([c.real, c.imag], -1))
        assert win is not None  # completed after the last symbol
        for s in range(nof_symbols):
            buf.set_symbol(0, s, win[s].astype(np.float32), port=p)
    assert buf.full
    occ = np.ascontiguousarray(np.transpose(buf.occasion(0), (1, 0, 2, 3))[None])
    dets = prach.prach_detect(torch.as_tensor(occ), cfg)[0]
    jdets = jax_prach.prach_detect(jnp.asarray(occ), jax_prach.PrachDetectorConfig(**kw))[0]
    assert [d[:2] for d in dets] == [d[:2] for d in jdets]
    assert any(d[0] == 7 for d in dets), dets
    pool.release(buf)


# ------------------------------------------------------------------- warmup --

def test_precompile_pusch_one_slot():
    """One slot variant of a 4-PRB configuration: the cached transmitter and
    receiver, run once; a second call finds them built; the receiver decodes
    the transmitter's slot as the JAX package's warm receiver does."""
    kw = dict(nof_rb=4, target_code_rate=0.3, nof_rx_ports=1, dft_size=512, numerology=1,
              dmrs_symbols=(2,), rnti=0x44, n_id=3)
    cfg = PuschRxConfig(modulation=Modulation.QPSK, **kw)
    seen = []
    out = precompile_pusch(cfg, 1, device="cpu", progress=lambda s, t: seen.append(s))
    assert list(out) == [0] and seen == [0]
    assert precompile_pusch(cfg, 1, device="cpu")[0] == out[0]
    assert slots_per_frame(1) == 20
    c0 = dataclasses.replace(cfg, slot=0)
    assert out[0] == (cached_ulsch_tx(c0, torch.device("cpu")),
                      cached_pusch_rx(c0, torch.device("cpu")))

    tx, rx = out[0]
    tb = np.random.default_rng(2).integers(0, 2, (1, cfg.tbs)).astype(np.uint8)
    _, samples = tx(torch.as_tensor(tb))
    res = rx(samples[:, None])
    assert bool(res["tb_crc_ok"][0])
    np.testing.assert_array_equal(flatten_tb_bits(res["tb_bits_cb"].numpy(), cfg.tbs), tb)
    jtx, jrx = jax_warmup.precompile_pusch(
        JaxPuschRxConfig(modulation=JaxModulation.QPSK, **kw), 1)[0]
    jres = jrx(jnp.asarray(samples[:, None].numpy()))
    for key in ("tb_crc_ok", "cb_crc_ok", "tb_bits_cb"):
        np.testing.assert_array_equal(res[key].numpy(), np.asarray(jres[key]), err_msg=key)


def test_warmed_upper_phy_first_ul_slot_builds_no_receiver():
    """`precompile_pusch` of a PDU's shape builds the FAPI entry point's
    receiver: a warmed UpperPhy's first `process_ul_slot` finds it cached
    (no new `cached_pusch_rx_from_grid` miss) and decodes."""
    pdu = PuschPdu(rnti=0x4601, rb_start=0, rb_size=5, modulation=Modulation.QPSK,
                   target_code_rate=0.31, n_id=3, dmrs_symbols=(2,), start_symbol=0,
                   nof_symbols=14)
    cfg = PuschRxConfig(nof_rb=5, modulation=Modulation.QPSK, target_code_rate=0.31,
                        nof_rx_ports=1, dft_size=512, numerology=1, dmrs_symbols=(2,),
                        rnti=0x4601, n_id=3)
    cell = CellConfig(nof_rb=5, dft_size=512, numerology=1)
    misses = cached_pusch_rx_from_grid.cache_info().misses
    precompile_pusch(cfg, 2, device="cpu")
    assert cached_pusch_rx_from_grid.cache_info().misses - misses == 2  # slot 0 and 1 of a subframe
    samples, tb = _four_prb_slot(pdu, 3, cfg)
    warm = cached_pusch_rx_from_grid.cache_info().misses
    inds = UpperPhy(cell, device="cpu").process_ul_slot(UlTtiRequest(slot=3, pusch=(pdu,)), samples)
    assert cached_pusch_rx_from_grid.cache_info().misses == warm
    assert [i for i in inds if isinstance(i, CrcIndication)][0].tb_crc_ok
    np.testing.assert_array_equal([i for i in inds if isinstance(i, RxDataIndication)][0].tb_bits,
                                  tb)


def _four_prb_slot(pdu, slot: int, cfg):
    """(samples (1, nsamples, 2), TB bits) of the carrier that `pdu` fills."""
    c = dataclasses.replace(cfg, slot=slot)
    tb = np.random.default_rng(slot).integers(0, 2, (1, c.tbs)).astype(np.uint8)
    _, samples = cached_ulsch_tx(c, torch.device("cpu"))(torch.as_tensor(tb))
    return samples.numpy(), tb[0]
