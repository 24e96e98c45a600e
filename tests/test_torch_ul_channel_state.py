"""PyTorch port, the channel state of the CRC indication on the CPU: the
port's PUSCH receiver held against the benchmark's plain reference receiver
(`portbench/reference/ul.py`, written from TS 38.211/38.212/38.214) and the
UE side's truth, on seeded TBs, RNTIs, noise levels and delays; the CRC
indications of `UpperPhy` and `MultiCellUpperPhy` and the counters of the
UL dispatch.  24 PRB, DFT 512, 4 rx ports, 2 layers of QAM256 R=948/1024
through the benchmark's fixed 4x2 channel.  No JAX.

Tolerances, each with its reason:
  * TB bits and CRC verdicts: exact (every row decodes on both sides);
  * TA, 1 ns of the applied delay: the delays are whole samples of the
    512-point DFT, which the port's 4096-point IDFT search hits exactly,
    and the reference's phase-slope estimate is continuous (0.1-0.3 ns off);
  * the SINR of the port and of the reference, each 1 dB of the channel's
    (the post-MMSE SINR with the channel known): both noise estimates are
    unbiased, the reference's on a channel flat over a PRB once the TA's
    ramp is removed, the port's once scaled by the smoothing residual's
    share and the pair despreading (`PuschRxConfig.unbiased_noise`); they
    read 0.4 dB or less off on these seeds, where the JAX package's
    estimate reads 5.4-5.9 dB high;
  * EVM within 60% of the reference's, both above the noise's own: both
    despread the DM-RS pairs across the delay's phase ramp, and the port's
    smoothing adds to the leaked layer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import ul as ref_ul
from portbench.reference.fapi import pdus as ref_pdus
from portbench.traffic.ul_pusch import channel, pusch_pdu
from srsran_projectvtlmo_tpu_torch.fapi import pdus
from srsran_projectvtlmo_tpu_torch.fapi.indications import CHANNEL_STATE, CrcIndication
from srsran_projectvtlmo_tpu_torch.ops.channel_estimate import noise_residual_share
from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy
from srsran_projectvtlmo_tpu_torch.phy import upper_phy
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu_torch.utils import tracing

NRB, DFT = 24, 512
CELL = dict(nof_rb=NRB, dft_size=DFT, numerology=1, nof_rx_ports=4)
PHY_CELL = CellConfig(nof_rb=NRB, dft_size=DFT, numerology=1, nof_tx_ports=4, nof_rx_ports=4)
SPEC = {"rb_start": 0, "rb_size": NRB, "modulation": "QAM256", "target_code_rate_x1024": 948,
        "nof_layers": 2, "start_symbol": 0, "nof_symbols": 14, "dmrs_symbols": [2], "rv": 0}
H = channel(0.5, 4, 2)
#: The benchmark's noise levels per real component: 40, 37, 34 and 31 dB per rx port.
NOISE_STD = (0.005, 0.0071, 0.01, 0.0141)
SAMPLE_NS = 1e9 / (DFT * 30e3)


def rows(seed: int, n: int, slot: int):
    """n rows of one slot: (port request, reference PDU, samples, TB, noise,
    delay) with the seed's RNTI, n_id, TB, noise level and delay."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rnti, n_id = int(rng.integers(1, 65520)), int(rng.integers(0, 1008))
        noise = float(rng.choice(NOISE_STD))
        delay = int(rng.integers(0, 2))
        ref = pusch_pdu(ref_pdus, SPEC, rnti, n_id)
        tb = rng.integers(0, 2, ref_ul.tbs(ref)).astype(np.uint8)
        x = ref_ul.transmit(ref, tb, slot, CELL, H, noise, delay, rng, "cpu")
        req = pdus.UlTtiRequest(slot=slot, pusch=(pusch_pdu(pdus, SPEC, rnti, n_id),))
        out.append((req, ref, x, tb, noise, delay))
    return out


@pytest.fixture(scope="module", params=[20260, 31337, 4242])
def batch(request):
    """Four cells of one slot through `MultiCellUpperPhy`, their counter
    record, and the reference receiver on each cell's samples."""
    slot_rows = rows(request.param, 4, 7)
    phy = MultiCellUpperPhy(PHY_CELL, 4, device="cpu")
    with tracing.entry("test.ul") as rec:
        out = phy.process_ul_slot([r[0] for r in slot_rows], np.stack([r[2] for r in slot_rows]))
    refs = [ref_ul.receive(torch.as_tensor(r[2]), r[1], 7, CELL) for r in slot_rows]
    return slot_rows, out, dict(rec), refs


def test_port_against_reference_and_truth(batch):
    slot_rows, out, _, refs = batch
    for (_, _, _, tb, noise, delay), inds, ref in zip(slot_rows, out, refs):
        crc, data = inds[0], inds[1]
        assert crc.tb_crc_ok and ref["tb_crc_ok"]
        np.testing.assert_array_equal(data.tb_bits, tb)
        np.testing.assert_array_equal(ref["tb_bits"], tb)
        truth = ref_ul.true_sinr_db(H, noise)
        assert abs(crc.timing_advance_ns - delay * SAMPLE_NS) <= 1.0
        assert abs(ref["ta_ns"] - delay * SAMPLE_NS) <= 1.0
        assert abs(ref["sinr_db"] - truth) <= 1.0
        assert abs(crc.ul_sinr_db - truth) <= 1.0
        floor = 10 ** (-truth / 20)  # the EVM the noise alone gives
        assert crc.evm >= 0.9 * floor and ref["evm"] >= 0.9 * floor
        assert abs(crc.evm / ref["evm"] - 1.0) <= 0.6


def test_multi_cell_crc_indications_carry_channel_state(batch):
    slot_rows, out, rec, _ = batch
    assert len(out) == 4
    for inds in out:
        crc = inds[0]
        assert isinstance(crc, CrcIndication) and isinstance(crc, pdus.CrcIndication)
        assert type(crc).__name__ == "CrcIndication"
        assert all(np.isfinite(getattr(crc, name)) for name in CHANNEL_STATE)
    assert rec["crc_channel_states"] == 4
    ncb = rec["pusch_cbs"] // 4
    assert rec["pusch_cbs"] == 4 * ncb and ncb > 1
    assert 4 * ncb <= rec["ldpc_sweeps"] <= 4 * ncb * 6
    assert "ul_graph_replays" not in rec and "ul_graph_captures" not in rec


def test_upper_phy_equals_multi_cell_row(batch):
    """One cell through `UpperPhy`: the same type and channel state as its
    row of the batch, one channel state counted per PUSCH, no replay on the
    CPU."""
    slot_rows, out, _, _ = batch
    req, _, x, tb, _, _ = slot_rows[2]
    phy = UpperPhy(PHY_CELL, device="cpu")
    with tracing.entry("test.ul1") as rec:
        inds = phy.process_ul_slot(req, x)
    crc = inds[0]
    assert type(crc) is type(out[2][0])
    assert crc.tb_crc_ok and np.array_equal(inds[1].tb_bits, tb)
    for name in CHANNEL_STATE:
        np.testing.assert_allclose(getattr(crc, name), getattr(out[2][0], name), rtol=1e-4,
                                   atol=1e-4)
    assert rec["crc_channel_states"] == 1
    assert "ul_graph_replays" not in rec


def test_unbiased_noise_against_the_jax_estimate(batch, monkeypatch):
    """The same row through `UpperPhy` with the JAX package's noise estimate
    (`PuschRxConfig.unbiased_noise` False) and with the port's: the first reads
    4-7 dB above the channel's SINR (the smoothing residual of the
    pair-despread pilots, 10 log10(2 / 0.5706) = 5.4 dB low in noise), the
    second within 1 dB; both decode the TB."""
    slot_rows, _, _, _ = batch
    req, _, x, tb, noise, _ = slot_rows[0]
    truth = ref_ul.true_sinr_db(H, noise)
    own, got = upper_phy.pusch_config, {}
    for unbiased in (False, True):
        monkeypatch.setattr(upper_phy, "pusch_config", lambda *a, **k: dataclasses.replace(
            own(*a, **k), unbiased_noise=unbiased))
        crc, data = UpperPhy(PHY_CELL, device="cpu").process_ul_slot(req, x)[:2]
        assert crc.tb_crc_ok and np.array_equal(data.tb_bits, tb)
        got[unbiased] = crc.ul_sinr_db - truth
    assert 4.0 <= got[False] <= 7.0
    assert abs(got[True]) <= 1.0


def test_noise_residual_share():
    """The smoothing residual's share of the pilot noise: 1 - 2 f_0 + sum f^2
    for one DM-RS symbol (0.5706 for the 7 taps at stride 4, 0.7850 for the
    15 at stride 2), nearer 1 the more symbols the smoothed mean averages."""
    assert noise_residual_share(273, 4, 1) == pytest.approx(0.57057, abs=1e-4)
    assert noise_residual_share(273, 2, 1) == pytest.approx(0.78496, abs=1e-4)
    assert noise_residual_share(24, 4, 1) == noise_residual_share(273, 4, 1)
    shares = [noise_residual_share(273, 2, n) for n in (1, 2, 4)]
    assert shares == sorted(shares) and shares[-1] < 1.0
