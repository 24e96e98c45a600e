"""PyTorch port, the lower PHY, the radio gateways and the host tooling
against the JAX package: `phy/lower` (amplitude control, the baseband slot
loop), `radio/gateway`, `utils/sanitizer` (with the PRACH buffer pool's
tracked lock) and `native` with `utils/bits`.

Tolerances and why:
  * indications, gateway samples, file bytes, sanitizer reports, packed
    words and CRCs: equal;
  * `AmplitudeController` against the JAX numpy version: the clipped
    samples within 1e-6 relative (float32 square roots and divisions in
    torch's order), the clipped ratio equal, the powers within 1e-5
    relative (float32 means summed in another order).
"""

import hashlib
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu_torch import native
from srsran_projectvtlmo_tpu_torch.phy.lower import AmplitudeController, LowerPhy
from srsran_projectvtlmo_tpu_torch.radio import FileIqSink, FileIqSource, LoopbackGateway
from srsran_projectvtlmo_tpu_torch.utils import bits, sanitizer
from srsran_projectvtlmo_tpu_torch.utils.sanitizer import Monitored, TrackedLock

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ lower PHY --

@pytest.mark.parametrize("gain_db,clip", [(6.0, True), (0.0, True), (-3.0, False), (12.0, True)])
def test_amplitude_controller_matches_jax(gain_db, clip):
    from srsran_projectvtlmo_tpu.phy.lower import AmplitudeController as JaxController

    x = (np.random.default_rng(4).normal(size=(2, 3000, 2)) * 0.4).astype(np.float32)
    out, m = AmplitudeController(gain_db, 1.0, clip).process(torch.as_tensor(x))
    want, jm = JaxController(gain_db, 1.0, clip).process(x)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-7)
    assert m.clipped_ratio == jm.clipped_ratio
    np.testing.assert_allclose([m.avg_power, m.peak_power, m.papr_db],
                               [jm.avg_power, jm.peak_power, jm.papr_db], rtol=1e-5)
    assert all(isinstance(v, float) for v in (m.avg_power, m.peak_power, m.clipped_ratio))


def test_amplitude_controller_clips_at_full_scale():
    """tests/test_aux.py's case: 6 dB on 0.6 clips every sample to 1."""
    x = np.zeros((100, 2), np.float32)
    x[:, 0] = 0.6
    out, m = AmplitudeController(gain_db=6.0, full_scale=1.0).process(x)
    assert m.clipped_ratio == 1.0
    assert np.allclose(np.sqrt((out.numpy() ** 2).sum(-1)), 1.0, atol=1e-5)
    _, m2 = AmplitudeController(gain_db=0.0).process(x)
    assert m2.clipped_ratio == 0.0 and m2.papr_db < 0.1


def _ul_samples(cell, pdu, slot, noise):
    """The port's UE transmitter for `pdu`, placed on the carrier, AWGN of
    `noise` per component, OFDM-modulated: (1, nsamples, 2) float32 and
    the TB bits."""
    from srsran_projectvtlmo_tpu_torch.models.pusch_rx import PuschRxConfig
    from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu_torch.ops import ofdm
    from srsran_projectvtlmo_tpu_torch.utils.cplx import from_cplx, to_cplx

    cfg = PuschRxConfig(nof_rb=pdu.rb_size, modulation=pdu.modulation,
                        target_code_rate=pdu.target_code_rate, rnti=pdu.rnti, n_id=pdu.n_id,
                        rb_start=pdu.rb_start, dmrs_symbols=pdu.dmrs_symbols,
                        dft_size=cell.dft_size, numerology=1, slot=slot)
    rng = np.random.default_rng(slot)
    tb = rng.integers(0, 2, (1, cfg.tbs)).astype(np.uint8)
    grid = to_cplx(build_ulsch_tx_slot(cfg, "cpu")(torch.as_tensor(tb))[0])
    carrier = torch.zeros((1, 14, cell.nof_rb * 12), dtype=torch.complex64)
    carrier[:, :, pdu.rb_start * 12:(pdu.rb_start + pdu.rb_size) * 12] = grid
    carrier += torch.as_tensor(noise * (rng.normal(size=carrier.shape)
                                        + 1j * rng.normal(size=carrier.shape)),
                               dtype=torch.complex64)
    return ofdm.ofdm_modulate(from_cplx(carrier), cell.dft_size, 1, slot % 2).numpy(), tb[0]


def test_lower_phy_matches_jax():
    """Two UL slots of a 24-PRB cell through each package's LowerPhy over a
    LoopbackGateway fed the same samples: a clean slot and a hopeless one
    give equal CRC and RxData indications; run_dl_slot transmits the
    amplitude-controlled DL samples."""
    from srsran_projectvtlmo_tpu.fapi import pdus as jax_pdus
    from srsran_projectvtlmo_tpu.phy.lower import LowerPhy as JaxLowerPhy
    from srsran_projectvtlmo_tpu.phy.upper_phy import CellConfig as JaxCell
    from srsran_projectvtlmo_tpu.phy.upper_phy import UpperPhy as JaxUpperPhy
    from srsran_projectvtlmo_tpu.radio import LoopbackGateway as JaxLoopback
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation as JaxMod
    from srsran_projectvtlmo_tpu_torch.fapi import pdus
    from srsran_projectvtlmo_tpu_torch.ops.ofdm import slot_sample_count
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
    from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation

    kw = dict(nof_rb=24, dft_size=512, numerology=1)
    cell = CellConfig(**kw)
    pdu_kw = dict(rnti=0x4601, rb_start=4, rb_size=16, target_code_rate=0.5, n_id=1,
                  dmrs_symbols=(2,))
    ours = LowerPhy(UpperPhy(cell, device="cpu"), LoopbackGateway(1))
    theirs = JaxLowerPhy(JaxUpperPhy(JaxCell(**kw)), JaxLoopback(1))
    for slot, noise in ((2, 0.01), (4, 3.0)):
        pdu = pdus.PuschPdu(modulation=Modulation.QAM16, **pdu_kw)
        samples, tb = _ul_samples(cell, pdu, slot, noise)
        ours.gateway.transmit(samples)
        theirs.gateway.transmit(samples)
        nsamp = slot_sample_count(512, 1, slot % 2)
        got = ours.run_ul_slot(pdus.UlTtiRequest(slot=slot, pusch=(pdu,)), nsamp)
        want = theirs.run_ul_slot(jax_pdus.UlTtiRequest(slot=slot, pusch=(
            jax_pdus.PuschPdu(modulation=JaxMod.QAM16, **pdu_kw),)), nsamp)
        assert [type(i).__name__ for i in got] == [type(i).__name__ for i in want]
        crc, jcrc = got[0], want[0]
        assert (crc.slot, crc.rnti, crc.harq_id, crc.tb_crc_ok) == \
            (jcrc.slot, jcrc.rnti, jcrc.harq_id, jcrc.tb_crc_ok)
        assert crc.tb_crc_ok == (noise < 1.0)
        if crc.tb_crc_ok:
            np.testing.assert_array_equal(got[1].tb_bits, want[1].tb_bits)
            np.testing.assert_array_equal(got[1].tb_bits, tb)

    from srsran_projectvtlmo_tpu_torch.fapi.pdus import DlTtiRequest, SsbPdu

    req = DlTtiRequest(slot=0, ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=0,
                                           half_radio_frame=False),))
    _, samples = ours.upper.process_dl_slot(req)
    ctl = AmplitudeController(gain_db=-20.0)
    metrics = LowerPhy(ours.upper, ours.gateway, ctl).run_dl_slot(req)
    want, want_m = ctl.process(samples)
    np.testing.assert_array_equal(ours.gateway.receive(samples.shape[-2])[0], want.numpy())
    assert metrics == want_m


# -------------------------------------------------------------- gateways --

def test_gateways_match_jax(tmp_path):
    """LoopbackGateway over partial reads, underflow and a 2-D (one-port)
    push; FileIqSink files byte-equal; FileIqSource reads equal."""
    from srsran_projectvtlmo_tpu.radio import FileIqSink as JaxSink
    from srsran_projectvtlmo_tpu.radio import FileIqSource as JaxSource
    from srsran_projectvtlmo_tpu.radio import LoopbackGateway as JaxLoopback

    rng = np.random.default_rng(1)
    chunks = [rng.normal(size=(1, 100, 2)).astype(np.float32),
              rng.normal(size=(70, 2)).astype(np.float32)]
    # One port with an underflow; two ports fed one-port samples (broadcast).
    for ports, reads in ((1, (60, 60, 30, 50)), (2, (60, 60, 50))):
        a, b = LoopbackGateway(ports), JaxLoopback(ports)
        for c in chunks:
            a.transmit(c)
            b.transmit(c)
        for n in reads:
            got, want = a.receive(n), b.receive(n)
            assert got.shape == want.shape == (ports, n, 2)
            np.testing.assert_array_equal(got, want)
    for gw_sink, src_cls, name in ((FileIqSink, FileIqSource, "a.bin"),
                                   (JaxSink, JaxSource, "b.bin")):
        sink = gw_sink(tmp_path / name)
        for c in chunks:
            sink.transmit(c)
        sink.close()
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    ours, theirs = FileIqSource(tmp_path / "a.bin", 3), JaxSource(tmp_path / "a.bin", 3)
    for n in (150, 200, 50):
        np.testing.assert_array_equal(ours.receive(n), theirs.receive(n))


# ------------------------------------------------------------- sanitizer --
# tests/test_sanitizer.py's cases against the port's copy and its threaded
# components (phy/realtime, phy/prach_buffer).

@pytest.fixture
def san():
    sanitizer.enable()
    yield sanitizer
    sanitizer.disable()


class _Counter:
    def __init__(self):
        self.value = 0


def _hammer(mon, lock=None, n=200):
    for _ in range(n):
        if lock is not None:
            with lock:
                mon.value = mon.value + 1
        else:
            mon.value = mon.value + 1


def _run_threads(targets) -> None:
    ts = [threading.Thread(target=t) for t in targets]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()


def test_unlocked_shared_write_is_reported(san):
    mon = Monitored(_Counter(), "counter")
    bar = threading.Barrier(2)

    def hammer_sync():
        bar.wait()
        _hammer(mon)

    _run_threads([hammer_sync, hammer_sync])
    assert any("data race" in r and "counter.value" in r for r in san.reports()), san.reports()


def test_common_lock_suppresses_report(san):
    mon = Monitored(_Counter(), "counter")
    lock = TrackedLock("counter_lock")
    _run_threads([lambda: _hammer(mon, lock)] * 2)
    assert not san.reports(), san.reports()
    assert mon.value == 400


def test_thread_local_init_then_publish_is_clean(san):
    mon = Monitored(_Counter(), "published")
    mon.value = 42
    seen = []
    _run_threads([lambda: seen.append(mon.value)] * 4)
    assert seen == [42] * 4
    assert not san.reports(), san.reports()


def test_lock_order_inversion_detected_without_deadlock(san):
    a, b = TrackedLock("A"), TrackedLock("B")

    def t1():
        with a:
            with b:
                pass

    _run_threads([t1])
    with b:
        with a:
            pass
    assert any("lock-order inversion" in r for r in san.reports()), san.reports()


def test_consistent_lock_order_is_clean(san):
    a, b = TrackedLock("A2"), TrackedLock("B2")
    for _ in range(10):
        with a:
            with b:
                pass
    assert not san.reports(), san.reports()


def test_baseband_chain_stress_is_race_free(san):
    from srsran_projectvtlmo_tpu_torch.phy.realtime import BasebandChain

    state = Monitored(_Counter(), "chain_state")
    lock = TrackedLock("chain_lock")

    def process(req):
        with lock:
            state.value = state.value + req
        return req * 2

    chain = BasebandChain("san-test", process, queue_depth=4)
    chain.start()
    try:
        for _ in range(50):
            chain.enqueue(1, timeout=5.0)
        got = 0
        deadline = time.time() + 10.0
        while got < 50 and time.time() < deadline:
            got += len(chain.results())
            time.sleep(0.005)
        with lock:
            total = state.value
    finally:
        chain.stop()
    assert got == 50 and total == 50
    assert not san.reports(), san.reports()


def test_prach_collector_cross_thread_misuse_detected(san):
    from srsran_projectvtlmo_tpu_torch.phy.realtime import PrachOccasionCollector

    col = PrachOccasionCollector()
    col.configure(slot=0, start_symbol=0, nof_symbols=64)
    mon = Monitored(col, "prach_collector")
    samp = np.zeros(8, np.complex64)
    bar = threading.Barrier(2)

    def feed(base):
        bar.wait()
        for s in range(base, 64, 2):
            mon.state = mon.state
            col.on_symbol(0, s, samp)

    _run_threads([lambda: feed(0), lambda: feed(1)])
    assert any("prach_collector.state" in r for r in san.reports())


def test_prach_buffer_pool_lock_is_tracked(san):
    """The pool's lock is a TrackedLock, as in the JAX package: taking it
    under another tracked lock records the order, and the reverse order
    is reported."""
    from srsran_projectvtlmo_tpu_torch.phy.prach_buffer import PrachBufferFormat, PrachBufferPool

    pool = PrachBufferPool(PrachBufferFormat(sequence_length=839, nof_ports=1), nof_buffers=2)
    assert isinstance(pool._lock, TrackedLock)
    outer = TrackedLock("slot_lock")
    with outer:
        buf = pool.reserve(0)
    assert not san.reports(), san.reports()
    with pool._lock:
        with outer:
            pass
    pool.release(buf)
    assert pool.nof_free == 2
    assert any("lock-order inversion" in r and "slot_lock" in r for r in san.reports())


def test_sanitizer_reports_match_jax():
    """One lock-order inversion and one race through both sanitizers: the
    same reports, the instance ids aside."""
    import re

    from srsran_projectvtlmo_tpu.utils import sanitizer as jax_sanitizer

    def drive(mod):
        mod.enable()
        try:
            a, b = mod.TrackedLock("A"), mod.TrackedLock("B")
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
            mon = mod.Monitored(_Counter(), "counter")
            bar = threading.Barrier(2)

            def hammer():
                bar.wait()
                _hammer(mon)

            _run_threads([hammer, hammer])
            return [re.sub(r"@0x[0-9a-f]+", "", r) for r in mod.reports()]
        finally:
            mod.disable()

    assert drive(sanitizer) == drive(jax_sanitizer)


# ---------------------------------------------------------------- native --

def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_native_builds_its_own_library_and_matches_jax():
    """The port builds csrc/host_kernels.cpp into _build/ (never the JAX
    package's native/, whose tracked library stays byte for byte the same)
    and its helpers equal the JAX package's native library and bit helpers."""
    from srsran_projectvtlmo_tpu import native as jax_native
    from srsran_projectvtlmo_tpu.ops.crc import POLYS
    from srsran_projectvtlmo_tpu.utils import bits as jax_bits

    tracked = REPO / "native" / "libsrsran_tpu_host.so"
    before = _sha256(tracked)
    assert native.available()
    path = native.library_path()
    assert path.parent == REPO / "srsran_projectvtlmo_tpu_torch" / "_build" and path.exists()
    rng = np.random.default_rng(0)
    for n in (0, 1, 31, 32, 1001):
        b = rng.integers(0, 2, n).astype(np.uint8)
        words = native.pack_bits(b)
        np.testing.assert_array_equal(words, jax_native.pack_bits(b))
        np.testing.assert_array_equal(words, jax_bits.pack_bits(b))
        np.testing.assert_array_equal(bits.pack_bits(b), jax_bits.pack_bits(b))
        np.testing.assert_array_equal(native.unpack_bits(words, n), b)
        np.testing.assert_array_equal(bits.unpack_bits(words, n), jax_bits.unpack_bits(words, n))
    for name in POLYS:
        for n in (8, 100, 1000):
            b = rng.integers(0, 2, n).astype(np.uint8)
            assert native.crc_bits(b, name) == jax_native.crc_bits(b, name), (name, n)
    ring = native.SpscRing(1024)
    data = rng.normal(size=(100, 2)).astype(np.float32)
    assert ring.write(data) == 100
    np.testing.assert_array_equal(ring.read(60), data[:60])
    out = ring.read(60)
    np.testing.assert_array_equal(out[:40], data[60:])
    assert (out[40:] == 0).all()
    assert _sha256(tracked) == before


def test_native_python_fallback_matches(monkeypatch):
    """Without the library the helpers take their pure-Python versions,
    with the same results, and available() says so."""
    rng = np.random.default_rng(2)
    b = rng.integers(0, 2, 300).astype(np.uint8)
    want = (native.pack_bits(b), native.crc_bits(b, "CRC24A"), native.crc_bits(b, "CRC11"))
    monkeypatch.setattr(native, "load", lambda: None)
    assert not native.available()
    got = (native.pack_bits(b), native.crc_bits(b, "CRC24A"), native.crc_bits(b, "CRC11"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(native.unpack_bits(got[0], 300), b)
    with pytest.raises(RuntimeError):
        native.SpscRing(16)


def test_host_kernels_source_is_a_copy():
    """The port's C++ source equals native/host_kernels.cpp below its
    leading comment."""
    ours = (REPO / "srsran_projectvtlmo_tpu_torch" / "csrc" / "host_kernels.cpp").read_text()
    theirs = (REPO / "native" / "host_kernels.cpp").read_text()
    assert ours[ours.index("#include"):] == theirs[theirs.index("#include"):]
