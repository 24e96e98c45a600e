"""PyTorch port, the uplink FAPI entry point against the JAX package:
`UpperPhy.process_ul_slot` on identical `UlTtiRequest`s and samples returns
the same indications.

Cells of 24 PRB, DFT 512, 30 kHz with 1 and 4 rx ports.  Slots are made on
the host from a numpy seed: the port's UL-SCH transmitter (held against the
JAX one in tests/test_torch_tx.py) for PUSCH, the generators of
tests/test_torch_pucch_prach_srs.py for PUCCH, SRS and PRACH, embedded in the
carrier, mixed onto the rx ports with AWGN and OFDM-modulated by the port.
The JAX `UpperPhy` and the port's `UpperPhy(..., device="cpu")` take the same
numpy samples; each request is converted field by field to the JAX
package's PDU classes.

Tolerances and why:
  * CRC flags, TB bits, HARQ/UCI/CSI bits, valid and SR flags, detected
    PRACH preambles and their TA, the HARQ counters: equal;
  * SRS channel, noise variance and TA, PRACH metrics: rtol 1e-4 with an
    absolute floor of 1e-5 of the values' scale (float32 FFT and estimator
    arithmetic in another order), as tests/test_torch_pucch_prach_srs.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import srsran_projectvtlmo_tpu.fapi.pdus as jax_pdus
from srsran_projectvtlmo_tpu.phy import prach_buffer as jax_prach_buffer
from srsran_projectvtlmo_tpu.phy import upper_phy as jax_upper_phy
from srsran_projectvtlmo_tpu.phy.harq import RxBufferPool as JaxRxBufferPool
from srsran_projectvtlmo_tpu.ran.modulation import Modulation as JaxModulation

from srsran_projectvtlmo_tpu_torch.fapi.indications import CHANNEL_STATE
from srsran_projectvtlmo_tpu_torch.fapi.pdus import (
    CrcIndication, PrachPdu, PucchPdu, PuschPdu, RxDataIndication, SrsPdu, UciIndication,
    UlTtiRequest)
from srsran_projectvtlmo_tpu_torch.models.pusch_rx import PuschRxConfig, cached_pusch_rx_from_grid
from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu_torch.ops import ofdm, prach, srs
from srsran_projectvtlmo_tpu_torch.phy import pucch, upper_phy
from srsran_projectvtlmo_tpu_torch.phy.harq import RxBufferPool
from srsran_projectvtlmo_tpu_torch.phy.prach_buffer import PrachBuffer, PrachBufferFormat
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import (
    CellConfig, FapiValidationError, UpperPhy)
from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation
from srsran_projectvtlmo_tpu_torch.utils.cplx import np_to_pair
from tests.test_torch_pucch_prach_srs import (
    _close, f0_signal, f1_signal, f2_signal, prach_occasion, srs_signal)

QAM16 = Modulation.QAM16
NOISE = 0.004


def cell(ports: int) -> CellConfig:
    return CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=ports, phys_cell_id=7)


def to_jax(x):
    """A port FAPI object (PDU, request, cell) as the JAX package's."""
    if isinstance(x, CellConfig):
        return jax_upper_phy.CellConfig(**dataclasses.asdict(x))
    if dataclasses.is_dataclass(x):
        cls = getattr(jax_pdus, type(x).__name__)
        return cls(**{f.name: to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(to_jax(v) for v in x)
    if isinstance(x, Modulation):
        return JaxModulation(x.value)
    return x


@pytest.fixture(autouse=True)
def jax_noise_estimate(monkeypatch):
    """The port's PUSCH receivers with the JAX package's noise estimate
    (`PuschRxConfig.unbiased_noise` False), so that their soft bits are
    JAX's."""
    own = upper_phy.pusch_config
    monkeypatch.setattr(upper_phy, "pusch_config", lambda *a, **k: dataclasses.replace(
        own(*a, **k), unbiased_noise=False))


def phys(ports: int):
    """(JAX UpperPhy, port UpperPhy on the CPU) of one cell."""
    c = cell(ports)
    return jax_upper_phy.UpperPhy(to_jax(c)), UpperPhy(c, device="cpu")


# ----------------------------------------------------------- slot making --

def tx_config(pdu: PuschPdu, slot: int, ports: int, **uci) -> PuschRxConfig:
    """The transmitter's configuration of one PUSCH PDU."""
    return PuschRxConfig(
        nof_rb=pdu.rb_size, modulation=pdu.modulation, target_code_rate=pdu.target_code_rate,
        nof_layers=pdu.nof_layers, nof_ofdm_symbols=pdu.nof_symbols,
        dmrs_symbols=tuple(s - pdu.start_symbol for s in pdu.dmrs_symbols), rv=pdu.rv,
        rnti=pdu.rnti, n_id=pdu.n_id, start_symbol=pdu.start_symbol, rb_start=pdu.rb_start,
        nof_rx_ports=ports, dft_size=512, numerology=1, slot=slot,
        nof_harq_ack_bits=pdu.nof_harq_ack_bits, nof_csi_part1_bits=pdu.nof_csi_part1_bits,
        dmrs_config_type=pdu.dmrs_config_type, hop_symbol=pdu.hop_symbol,
        second_hop_prb=pdu.second_hop_prb, **uci)


def place_pusch(carrier: np.ndarray, pdu: PuschPdu, slot: int, tb: np.ndarray,
                uci: dict | None = None, csi2: int | None = None) -> None:
    """Add one PUSCH PDU's transmission to the (P, 14, nsubc) carrier: the
    port's transmitter, its layers mixed onto the ports, each symbol at its
    hop's PRB."""
    ports = carrier.shape[0]
    cfg = tx_config(pdu, slot, ports)
    tx = build_ulsch_tx_slot(cfg, "cpu", nof_csi_part2_bits=csi2)
    kw = {k: torch.as_tensor(v[None]) for k, v in (uci or {}).items()}
    grid = tx(torch.as_tensor(tb[None]), **kw)[0][0].numpy()
    grid = (grid[..., 0] + 1j * grid[..., 1]).reshape(pdu.nof_layers, pdu.nof_symbols, -1)
    p, l = np.arange(ports)[:, None], np.arange(pdu.nof_layers)[None, :]
    mix = ((p % pdu.nof_layers == l) + 0.1) * np.exp(0.7j * p)
    for s in range(pdu.nof_symbols):
        sym = pdu.start_symbol + s
        prb = pdu.second_hop_prb if pdu.hop_symbol is not None and sym >= pdu.hop_symbol \
            else pdu.rb_start
        carrier[:, sym, prb * 12:(prb + pdu.rb_size) * 12] += mix @ grid[:, s]


def port_gains(ports: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=ports) + 1j * rng.normal(size=ports)) / np.sqrt(2) + 0.5


def modulate(carrier: np.ndarray, slot: int, seed: int, noise: float = NOISE) -> np.ndarray:
    """(P, 14, nsubc) carrier plus AWGN -> (P, nsamples, 2) samples."""
    rng = np.random.default_rng(seed)
    carrier = carrier + noise * (rng.normal(size=carrier.shape)
                                 + 1j * rng.normal(size=carrier.shape))
    return ofdm.ofdm_modulate(torch.as_tensor(np_to_pair(carrier)), 512, 1, slot % 2).numpy()


def pusch_slot(pdu: PuschPdu, slot: int, ports: int, seed: int, uci=None, csi2=None,
               noise: float = NOISE):
    """(samples, TB bits) of a slot that carries one PUSCH PDU."""
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, tx_config(pdu, slot, ports).tbs).astype(np.uint8)
    carrier = np.zeros((ports, 14, 24 * 12), np.complex64)
    place_pusch(carrier, pdu, slot, tb, uci, csi2)
    return modulate(carrier, slot, seed + 1, noise), tb


# ------------------------------------------------------------- comparing --

def compare(jinds: list, tinds: list) -> None:
    """The port's indications equal the JAX package's, one by one."""
    assert [type(i).__name__ for i in tinds] == [type(i).__name__ for i in jinds]
    for j, t in zip(jinds, tinds):
        name = type(t).__name__
        for f in dataclasses.fields(t):
            if f.name in CHANNEL_STATE and not hasattr(j, f.name):
                continue  # the JAX package's CRC indication carries no channel state
            a, b = getattr(t, f.name), getattr(j, f.name)
            if name == "SrsIndication" and f.name in ("channel", "noise_var", "time_alignment_s"):
                _close(a, b)
            elif f.name in CHANNEL_STATE:
                _close(a, b)
            elif name == "RachIndication" and f.name == "preambles":
                assert [p[:2] for p in a] == [p[:2] for p in b], (a, b)
                _close([p[2] for p in a], [p[2] for p in b])
            elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                assert a is not None and b is not None, (name, f.name)
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name}.{f.name}")
            else:
                assert a == b, (name, f.name, a, b)


def run_both(pair, request: UlTtiRequest, samples, prach_samples=None):
    """(JAX indications, port indications) of one slot."""
    jphy, tphy = pair
    jprach = prach_samples
    if isinstance(prach_samples, PrachBuffer):
        jprach = jax_prach_buffer.PrachBuffer(
            jax_prach_buffer.PrachBufferFormat(**dataclasses.asdict(prach_samples.fmt)), 0)
        jprach._data[:], jprach._filled[:] = prach_samples._data, prach_samples._filled
    jinds = jphy.process_ul_slot(to_jax(request), samples, jprach)
    tinds = tphy.process_ul_slot(request, samples, prach_samples)
    compare(jinds, tinds)
    return jinds, tinds


def of_type(inds, cls):
    return [i for i in inds if type(i).__name__ == cls.__name__]


# ------------------------------------------------------------ PUSCH cases --

def _pdu(**kw) -> PuschPdu:
    base = dict(rnti=0x4601, rb_start=4, rb_size=16, modulation=QAM16, target_code_rate=0.5,
                n_id=3, dmrs_symbols=(2, 11))
    return PuschPdu(**{**base, **kw})


PUSCH_CASES = {  # name -> (rx ports, PDU, UCI payload bits)
    "sch_1port": (1, _pdu(), {}),
    "sch_4port_2layer": (4, _pdu(nof_layers=2), {}),
    "ack2": (1, _pdu(nof_harq_ack_bits=2), {"ack_bits": np.array([1, 0], np.uint8)}),
    "csi_constant_part2": (1, _pdu(nof_csi_part1_bits=2, part2_size_map=(6, 6, 6, 6)),
                           {"csi1_bits": np.array([0, 1], np.uint8),
                            "csi2_bits": np.array([1, 0, 0, 1, 1, 0], np.uint8)}),
    "hopping": (1, _pdu(rb_start=2, rb_size=8, dmrs_symbols=(2, 9), hop_symbol=7,
                        second_hop_prb=14), {}),
    "dmrs_type2": (4, _pdu(dmrs_config_type=2), {}),
}


@pytest.mark.parametrize("name", sorted(PUSCH_CASES))
def test_pusch_slot_matches_jax(name):
    ports, pdu, uci = PUSCH_CASES[name]
    slot = 5
    csi2 = len(uci["csi2_bits"]) if "csi2_bits" in uci else None
    samples, tb = pusch_slot(pdu, slot, ports, seed=len(name), uci=uci, csi2=csi2)
    _, inds = run_both(phys(ports), UlTtiRequest(slot=slot, pusch=(pdu,)), samples)
    assert of_type(inds, CrcIndication)[0].tb_crc_ok
    np.testing.assert_array_equal(of_type(inds, RxDataIndication)[0].tb_bits, tb)
    ucis = of_type(inds, UciIndication)
    assert len(ucis) == bool(uci)
    if "ack_bits" in uci:
        assert ucis[0].valid
        np.testing.assert_array_equal(ucis[0].harq_bits, uci["ack_bits"])
    if "csi1_bits" in uci:
        assert ucis[0].csi1_valid and ucis[0].csi2_valid
        np.testing.assert_array_equal(ucis[0].csi1_bits, uci["csi1_bits"])
        np.testing.assert_array_equal(ucis[0].csi2_bits, uci["csi2_bits"])


def test_ue_churn_builds_one_receiver():
    """Three UEs of one shape (distinct rnti, n_id and slot, with a 2-bit
    ACK) share one cached receiver: rnti, n_id and the slot within the
    frame ride as inputs."""
    pair = phys(1)
    cached_pusch_rx_from_grid.cache_clear()
    for i, (rnti, n_id, slot) in enumerate([(0x17, 5, 2), (0x23, 7, 4), (0x31, 11, 16)]):
        pdu = _pdu(rnti=rnti, n_id=n_id, nof_harq_ack_bits=2)
        ack = np.array([i & 1, 1], np.uint8)
        samples, tb = pusch_slot(pdu, slot, 1, seed=20 + i, uci={"ack_bits": ack})
        _, inds = run_both(pair, UlTtiRequest(slot=slot, pusch=(pdu,)), samples)
        assert of_type(inds, CrcIndication)[0].tb_crc_ok
        np.testing.assert_array_equal(of_type(inds, RxDataIndication)[0].tb_bits, tb)
        np.testing.assert_array_equal(of_type(inds, UciIndication)[0].harq_bits, ack)
    assert cached_pusch_rx_from_grid.cache_info().misses == 1, \
        cached_pusch_rx_from_grid.cache_info()


def test_retransmission_combines_through_the_arena():
    """A TB sent at a noise level where it fails, then its retransmission
    (new_data=False): the arena holds the same soft bits as the JAX pool
    after the first pass, the retransmission decodes to the TB, and the
    reservation is released after the pass."""
    pair = phys(1)
    jphy, tphy = pair
    first = _pdu(modulation=Modulation.QPSK, harq_id=3)
    again = dataclasses.replace(first, new_data=False)
    rng = np.random.default_rng(40)
    tb = rng.integers(0, 2, tx_config(first, 6, 1).tbs).astype(np.uint8)
    results = []
    for pdu, seed in ((first, 41), (again, 42)):
        carrier = np.zeros((1, 14, 24 * 12), np.complex64)
        place_pusch(carrier, pdu, 6, tb)
        results.append(run_both(pair, UlTtiRequest(slot=6, pusch=(pdu,)),
                                modulate(carrier, 6, seed, noise=0.62))[1])
        if len(results) == 1:
            assert not of_type(results[0], CrcIndication)[0].tb_crc_ok
            assert tphy.harq_pool.nof_reserved == jphy.harq_pool.nof_reserved == 1
            idx = tphy.harq_pool._reservations[(first.rnti, 3)].buffer_index
            jidx = jphy.harq_pool._reservations[(first.rnti, 3)].buffer_index
            np.testing.assert_array_equal(tphy.harq_pool._soft[idx].numpy(),
                                          np.asarray(jphy.harq_pool._soft[jidx]))
            assert tphy.harq_pool._soft[idx].abs().sum() > 0
    assert of_type(results[1], CrcIndication)[0].tb_crc_ok
    np.testing.assert_array_equal(of_type(results[1], RxDataIndication)[0].tb_bits, tb)
    assert tphy.harq_pool.nof_reserved == jphy.harq_pool.nof_reserved == 0


def test_harq_pool_reserve_release_expire_as_jax():
    """The reservation map: distinct buffers, exhaustion, re-acquisition by
    the same key, release and expiry, step by step as the JAX pool."""
    kw = dict(nof_buffers=2, max_codeblocks=2, max_cb_size=128, expiry_slots=10)
    pools = (RxBufferPool(**kw, device="cpu"), JaxRxBufferPool(**kw))
    for pool in pools:
        steps = [pool.reserve(0, rnti=1, harq_id=0, nof_cb=2, new_data=True),
                 pool.reserve(0, rnti=2, harq_id=0, nof_cb=2, new_data=True),
                 pool.reserve(0, rnti=3, harq_id=0, nof_cb=2, new_data=True),
                 pool.reserve(1, rnti=1, harq_id=0, nof_cb=2, new_data=False)]
        pool.release(1, 0)
        steps += [pool.reserve(2, rnti=3, harq_id=0, nof_cb=1, new_data=True),
                  pool.nof_reserved]
        pool.run_slot(100)
        steps.append(pool.nof_reserved)
        pool.steps = steps
    assert pools[0].steps == pools[1].steps
    assert pools[0].steps[2] is None and pools[0].steps[0] == pools[0].steps[3]
    assert pools[0].steps[-1] == 0


def test_harq_pool_combined_as_jax():
    """`combined` promotion-sums new LLRs into a buffer in place and returns
    the sum, as the JAX pool does functionally; new data zeroes the buffer."""
    import jax.numpy as jnp

    kw = dict(nof_buffers=2, max_codeblocks=3, max_cb_size=40)
    ours, theirs = RxBufferPool(**kw, device="cpu"), JaxRxBufferPool(**kw)
    rng = np.random.default_rng(9)
    for pool in (ours, theirs):
        pool.idx = pool.reserve(0, rnti=7, harq_id=1, nof_cb=3, new_data=True)
    for _ in range(3):
        llr = rng.integers(-127, 128, (3, 32)).astype(np.int8)
        got = ours.combined(ours.idx, 3, 32, torch.as_tensor(llr))
        want = theirs.combined(theirs.idx, 3, 32, jnp.asarray(llr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ours._soft.numpy(), np.asarray(theirs._soft))
    view = ours.get_soft(ours.idx, 3, 32)
    assert view.data_ptr() == ours._soft[ours.idx].data_ptr() and view.abs().sum() > 0
    assert ours.reserve(1, rnti=7, harq_id=1, nof_cb=3, new_data=True) == ours.idx
    assert not view.any()


def test_pool_exhaustion_is_counted():
    """A one-buffer pool held by a UE whose TB failed: another UE's
    retransmission decodes without history and is counted."""
    pair = phys(1)
    pdu = _pdu(modulation=Modulation.QPSK)
    seg = tx_config(pdu, 0, 1).segmentation
    kw = dict(nof_buffers=1, max_codeblocks=seg.nof_cb, max_cb_size=seg.nof_cw_bits_per_cb)
    pair[0].harq_pool, pair[1].harq_pool = JaxRxBufferPool(**kw), RxBufferPool(**kw,
                                                                                device="cpu")
    noise_only = modulate(np.zeros((1, 14, 24 * 12), np.complex64), 2, 50, noise=0.3)
    _, inds = run_both(pair, UlTtiRequest(slot=2, pusch=(_pdu(rnti=0x11, modulation=Modulation.QPSK),)),
                       noise_only)
    assert not of_type(inds, CrcIndication)[0].tb_crc_ok
    retx = _pdu(rnti=0x22, modulation=Modulation.QPSK, new_data=False)
    samples, tb = pusch_slot(retx, 3, 1, seed=51)
    _, inds = run_both(pair, UlTtiRequest(slot=3, pusch=(retx,)), samples)
    np.testing.assert_array_equal(of_type(inds, RxDataIndication)[0].tb_bits, tb)
    assert pair[1].nof_dropped_harq_reservations == pair[0].nof_dropped_harq_reservations == 1


def test_invalid_request_raises():
    pair = phys(1)
    samples = np.zeros((1, ofdm.slot_sample_count(512, 1, 0), 2), np.float32)
    bad = UlTtiRequest(slot=0, pusch=(_pdu(rv=2),), pucch=(PucchPdu(
        format=0, rnti=5, prb_start=0, nof_prb=2, start_symbol=12, nof_symbols=2),))
    with pytest.raises(jax_upper_phy.FapiValidationError) as jerr:
        pair[0].process_ul_slot(to_jax(bad), samples)
    with pytest.raises(FapiValidationError) as terr:
        pair[1].process_ul_slot(bad, samples)
    assert str(terr.value) == str(jerr.value)
    assert len(terr.value.report.errors) == 2


def test_invalid_dl_request_raises_as_jax():
    """The downlink half of the entry point (tests/test_torch_dl_slot.py holds
    the slots): a DL request that fails FAPI validation raises with the JAX
    UpperPhy's report."""
    from srsran_projectvtlmo_tpu_torch.fapi.pdus import DlTtiRequest, PdschPdu, TxDataRequest

    pdu = PdschPdu(rnti=0x10, rb_start=20, rb_size=8, modulation=QAM16, target_code_rate=0.5,
                   nof_layers=2, rv=5)
    bad = DlTtiRequest(slot=3, pdsch=(pdu,))
    data = TxDataRequest(slot=4, tb_bits=[])
    pair = phys(1)
    with pytest.raises(jax_upper_phy.FapiValidationError) as jerr:
        pair[0].process_dl_slot(to_jax(bad), to_jax(data))
    with pytest.raises(FapiValidationError) as terr:
        pair[1].process_dl_slot(bad, data)
    assert str(terr.value) == str(jerr.value)
    assert len(terr.value.report.errors) >= 2


# -------------------------------------------------------------- mixed slot --

MIXED_SLOT = 9
#: Two-phase CSI: a 2-bit part 1 selects the part-2 size.
PART2_MAP = (0, 4, 8, 11)
MIXED_PUSCH = _pdu(rnti=0x4601, rb_start=0, rb_size=12, nof_symbols=13,
                   nof_harq_ack_bits=2, nof_csi_part1_bits=2, part2_size_map=PART2_MAP)
F0_PDU = PucchPdu(format=0, rnti=0x51, prb_start=13, nof_prb=1, start_symbol=12, nof_symbols=2,
                  initial_cyclic_shift=3, nof_harq_bits=2, sr_opportunity=True, n_id=7)
F1_PDU = PucchPdu(format=1, rnti=0x52, prb_start=12, nof_prb=1, start_symbol=0, nof_symbols=14,
                  initial_cyclic_shift=2, time_domain_occ=1, nof_harq_bits=2, n_id=7,
                  second_hop_prb=23)
F2_PDU = PucchPdu(format=2, rnti=0x53, prb_start=14, nof_prb=2, start_symbol=12, nof_symbols=2,
                  nof_uci_bits=7, n_id=9, n_id0=11)
SRS_PDU = SrsPdu(rnti=0x54, nof_rb=6, prb_start=16, comb_size=2, comb_offset=1, start_symbol=13,
                 sequence_id=5)
PRACH_PDU = PrachPdu(root_sequence_index=22, zero_correlation_zone=11)
PRACH_PREAMBLE = 11


def pucch_configs(slot: int):
    """The detector configurations of the mixed slot's PUCCH PDUs."""
    f0 = pucch.PucchFormat0Config(n_id=F0_PDU.n_id, slot=slot, start_symbol=12, nof_symbols=2,
                                  initial_cyclic_shift=3, nof_harq_bits=2, sr_opportunity=True)
    f1 = pucch.PucchFormat1Config(n_id=F1_PDU.n_id, slot=slot, start_symbol=0, nof_symbols=14,
                                  initial_cyclic_shift=2, time_domain_occ=1, nof_harq_bits=2,
                                  intra_slot_hopping=True)
    f2 = pucch.PucchFormat2Config(n_id=9, n_id0=11, rnti=F2_PDU.rnti, slot=slot, start_symbol=12,
                                  nof_symbols=2, nof_prb=2, nof_uci_bits=7)
    return f0, f1, f2


@pytest.fixture(scope="module")
def mixed():
    """The mixed slot on the 4-port cell, made once; what was sent."""
    ports, rng = 4, np.random.default_rng(60)
    sent = {"ack_bits": np.array([0, 1], np.uint8), "csi1_bits": np.array([1, 0], np.uint8),
            "csi2_bits": rng.integers(0, 2, PART2_MAP[2]).astype(np.uint8),
            "f0": (1, 1), "f1": (1, 0), "f2": rng.integers(0, 2, 7).astype(np.uint8)}
    tb = rng.integers(0, 2, tx_config(MIXED_PUSCH, MIXED_SLOT, ports).tbs).astype(np.uint8)
    carrier = np.zeros((ports, 14, 24 * 12), np.complex64)
    place_pusch(carrier, MIXED_PUSCH, MIXED_SLOT, tb,
                {k: sent[k] for k in ("ack_bits", "csi1_bits", "csi2_bits")}, PART2_MAP[2])
    f0, f1, f2 = pucch_configs(MIXED_SLOT)
    h = port_gains(ports, 61)[:, None, None]
    carrier[:, 12:14, 13 * 12:14 * 12] += h * f0_signal(f0, sent["f0"])
    f1_tx = f1_signal(f1, sent["f1"])
    carrier[:, 0:7, 12 * 12:13 * 12] += h * f1_tx[:7]
    carrier[:, 7:14, 23 * 12:24 * 12] += h * f1_tx[7:]
    carrier[:, 12:14, 14 * 12:16 * 12] += h * f2_signal(f2, sent["f2"])
    scfg = srs.SrsConfig(nof_rb=6, comb_size=2, comb_offset=1, start_symbol=13, sequence_id=5)
    carrier[:, 13:14, 16 * 12:22 * 12] += h * srs_signal(scfg)
    samples = modulate(carrier, MIXED_SLOT, 62)

    pcfg = prach.PrachDetectorConfig(sequence_length=prach.LONG, root_sequence_index=22,
                                     zero_correlation_zone=11)
    occ = prach_occasion(pcfg, PRACH_PREAMBLE, ports, 1, 3.0, rng, delay=4.0)  # (P, 1, L)
    buf = PrachBuffer(PrachBufferFormat(sequence_length=prach.LONG, nof_ports=ports), 0)
    buf.set_symbol(0, 0, np_to_pair(occ[:, 0]))
    request = UlTtiRequest(slot=MIXED_SLOT, pusch=(MIXED_PUSCH,),
                           pucch=(F0_PDU, F1_PDU, F2_PDU), srs=(SRS_PDU,), prach=(PRACH_PDU,))
    pair = phys(ports)
    jinds, inds = run_both(pair, request, samples, buf)
    return dict(sent=sent, tb=tb, inds=inds, h=h[:, 0, 0], pair=pair, buf=buf,
                samples=samples, request=request)


def test_mixed_slot_matches_jax_and_what_was_sent(mixed):
    sent, inds = mixed["sent"], mixed["inds"]
    names = [type(i).__name__ for i in inds]
    assert names == ["CrcIndication", "RxDataIndication", "UciIndication", "UciIndication",
                     "UciIndication", "UciIndication", "SrsIndication", "RachIndication"]
    crc, rxd, pusch_uci, u0, u1, u2, srs_ind, rach = inds
    assert crc.tb_crc_ok
    np.testing.assert_array_equal(rxd.tb_bits, mixed["tb"])
    assert pusch_uci.valid and pusch_uci.csi1_valid and pusch_uci.csi2_valid
    for key, got in (("ack_bits", pusch_uci.harq_bits), ("csi1_bits", pusch_uci.csi1_bits),
                     ("csi2_bits", pusch_uci.csi2_bits)):
        np.testing.assert_array_equal(got, sent[key], err_msg=key)
    assert u0.valid and u0.sr_detected
    np.testing.assert_array_equal(u0.harq_bits, sent["f0"])
    assert u1.valid
    np.testing.assert_array_equal(u1.harq_bits, sent["f1"])
    assert u2.valid
    np.testing.assert_array_equal(u2.uci_bits, sent["f2"])
    # The SRS channel per rx port is the port's gain, within the noise.
    assert srs_ind.channel.shape == (4, 6 * 12)
    err = np.abs(srs_ind.channel - mixed["h"][:, None]).max()
    assert err < 0.05 * np.abs(mixed["h"]).min(), err
    assert max(rach.preambles, key=lambda d: d[2])[0] == PRACH_PREAMBLE


def test_partial_prach_occasion_is_dropped(mixed):
    """An occasion whose capture buffer is not full is skipped and counted,
    and the other PDUs of the slot are processed as before."""
    buf = PrachBuffer(PrachBufferFormat(sequence_length=prach.LONG, nof_ports=4), 0)
    buf.set_symbol(0, 0, mixed["buf"].occasion(0)[0, 0], port=0)
    request = dataclasses.replace(mixed["request"], pusch=(), srs=())
    _, inds = run_both(mixed["pair"], request, mixed["samples"], buf)
    assert [type(i).__name__ for i in inds] == ["UciIndication"] * 3
    assert mixed["pair"][1].nof_dropped_prach_occasions == \
        mixed["pair"][0].nof_dropped_prach_occasions == 1


def test_single_port_prach_array(mixed):
    """An (L, 2) occasion array in place of a buffer."""
    occ = mixed["buf"].occasion(0)[0, 0]
    request = UlTtiRequest(slot=MIXED_SLOT, prach=(PRACH_PDU,))
    _, inds = run_both(phys(1), request, None, occ)
    assert max(inds[0].preambles, key=lambda d: d[2])[0] == PRACH_PREAMBLE
