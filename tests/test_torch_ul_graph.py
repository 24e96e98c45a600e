"""PyTorch port, the batched PUSCH receiver's CUDA graphs on the card: replays
equal the eager receiver bit for bit (TB bits, verdicts, HARQ soft bits,
channel state), for new data and for a retransmission that combines;
captures happen on a replay key's second call only; the receiver with the
demap kernel equals it with the plain demap; the FAPI entry's counters and
indications across eager, captured and replayed calls.

Every test needs an NVIDIA card and skips without one.  This file imports no
JAX, so it runs where the card is, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ul_graph.py

The slots come from the benchmark's UE side (`portbench.reference.ul`): four
100 MHz 4x2 cells, a 2-layer QAM256 PUSCH on 273 PRB in each.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import ul as ref_ul
from portbench.reference.fapi import pdus as ref_pdus
from portbench.traffic.ul_pusch import channel, pusch_pdu
from srsran_projectvtlmo_tpu_torch.fapi import pdus
from srsran_projectvtlmo_tpu_torch.fapi.indications import CrcIndication
from srsran_projectvtlmo_tpu_torch.models import pusch_rx
from srsran_projectvtlmo_tpu_torch.models.pusch_rx import (
    cached_demux_plan, cached_pusch_rx_from_grid)
from srsran_projectvtlmo_tpu_torch.ops import pusch_demap
from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy
from srsran_projectvtlmo_tpu_torch.phy import ul_graph
from srsran_projectvtlmo_tpu_torch.ops.ofdm import ofdm_demodulate
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import (
    CellConfig, ExpertPhyConfig, extract_pusch_allocation, pusch_batch_key, pusch_config,
    pusch_rx_key, pusch_sequences)
from srsran_projectvtlmo_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "portbench" / "traffic" / "ul_pusch_full.json").read_text())["pusch"]
CELL = dict(nof_rb=273, dft_size=4096, numerology=1, nof_rx_ports=4)
PHY_CELL = CellConfig(nof_rb=273, dft_size=4096, numerology=1, nof_tx_ports=4, nof_rx_ports=4)
NCELL = 4
#: Where the UE side runs its LDPC encoder.
DEVICE = "cuda"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the PUSCH receiver's CUDA graphs exist only there")
    ul_graph._replays.cache_clear()
    return torch.device("cuda", torch.cuda.current_device())


def ul_slot(slot: int, seed: int, noise: float = 0.005, rv: int = 0):
    """(requests, samples (NCELL, 4, nsamples, 2), TBs) of one slot: the
    seed's RNTI, n_id, TB and delay per cell, and noise drawn anew per rv."""
    rng, rng_noise = np.random.default_rng(seed), np.random.default_rng([seed, rv])
    h = channel(0.5, 4, 2)
    spec = dict(SPEC, rv=rv)
    reqs, samples, tbs = [], [], []
    for _ in range(NCELL):
        rnti, n_id = int(rng.integers(1, 65520)), int(rng.integers(0, 1008))
        ref = pusch_pdu(ref_pdus, spec, rnti, n_id)
        tb = rng.integers(0, 2, ref_ul.tbs(ref)).astype(np.uint8)
        delay = int(rng.integers(0, 9))
        samples.append(ref_ul.transmit(ref, tb, slot, CELL, h, noise, delay, rng_noise, DEVICE))
        reqs.append(pdus.UlTtiRequest(slot=slot, pusch=(pusch_pdu(pdus, spec, rnti, n_id),)))
        tbs.append(tb)
    return reqs, np.stack(samples), tbs


def receiver_args(card, reqs, samples, harq_in=None, nof_csi2=0):
    """(rx_cfg, the receiver call, its replay key, its inputs) as
    `process_pusch_batch` makes them, with the UCI fix signs where the PDUs
    carry UCI (`nof_csi2`: their constant CSI part-2 size)."""
    slot = reqs[0].slot
    grid = ofdm_demodulate(torch.as_tensor(samples, device=card), PHY_CELL.nof_subc,
                           PHY_CELL.dft_size, PHY_CELL.numerology, slot % 2)
    valued = [pusch_config(PHY_CELL, ExpertPhyConfig(), slot, r.pusch[0], nof_csi2=nof_csi2,
                           two_phase=False) for r in reqs]
    rx_cfg = pusch_rx_key(valued[0])
    p0 = reqs[0].pusch[0]
    plan = None
    if p0.nof_harq_ack_bits or p0.nof_csi_part1_bits:
        plan, _ = cached_demux_plan(rx_cfg, nof_csi2)
    seqs = [pusch_sequences(v, plan) for v in valued]
    ref = torch.as_tensor(np.stack([s[0] for s in seqs]), device=card)
    signs = torch.as_tensor(np.stack([s[2] for s in seqs]), device=card)
    uci_fix = None if plan is None else tuple(
        None if seqs[0][3][k] is None else
        torch.as_tensor(np.stack([s[3][k] for s in seqs]), dtype=torch.int8, device=card)
        for k in range(3))
    fn = functools.partial(ul_graph.receive, cached_pusch_rx_from_grid(rx_cfg, card))
    key = (pusch_batch_key(p0), len(reqs), harq_in is not None)
    return rx_cfg, fn, key, (extract_pusch_allocation(grid, p0), harq_in, ref, signs, uci_fix)


OUTPUTS = ("tb_crc_ok", "tb_bits_cb", "harq_soft", "ldpc_iterations", "snr_db", "ta_s", "evm",
           "rows")


def replayed(rx_cfg, fn, key, args, calls: int = 3):
    """The outputs of `calls` calls through `receiver_outputs`, cloned, with
    each call's counter record."""
    outs = []
    for _ in range(calls):
        with tracing.entry("test.ul_graph") as rec:
            with ul_graph.receiver_outputs(rx_cfg, key, fn, args) as out:
                outs.append(({k: out[k].clone() for k in OUTPUTS}, dict(rec)))
        torch.cuda.synchronize()
    return outs


def assert_equal(got: dict, want: dict):
    for k in OUTPUTS:
        assert torch.equal(got[k], want[k]), k


def test_new_data_replay_equals_eager(card):
    """Four cells of new data: the key's first call runs eagerly, its second
    captures and replays, its third replays; every output equals the eager
    receiver's bit for bit, and every TB decodes."""
    reqs, samples, tbs = ul_slot(4, 1)
    rx_cfg, fn, key, args = receiver_args(card, reqs, samples)
    with torch.no_grad():
        want = fn(*args)
    outs = replayed(rx_cfg, fn, key, args)
    assert [rec.get("ul_graph_captures", 0) for _, rec in outs] == [0, 1, 0]
    assert [rec["ul_graph_replays"] for _, rec in outs] == [0, 1, 1]
    for got, _ in outs:
        assert_equal(got, want)
    assert bool(want["tb_crc_ok"].all())
    bits = want["tb_bits_cb"].reshape(NCELL, -1)[:, :len(tbs[0])].cpu().numpy()
    assert all(np.array_equal(b, tb) for b, tb in zip(bits, tbs))


def kernel_and_plain(card, monkeypatch, rx_cfg, fn, args):
    """The outputs of the cached receiver `fn`, whose demap stage is the
    kernel, launched once, and of a receiver of `rx_cfg` built with the
    plain demap, on `args`."""
    assert fn.args[0].demap_kernel
    with torch.no_grad():
        pusch_demap.reset_launch_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        assert pusch_demap.LAUNCHES["pusch_demap"] == 1
        monkeypatch.setattr(pusch_rx, "demap_route",
                            lambda dev: pusch_demap.demap_descramble_plain)
        plain = pusch_rx.build_pusch_rx_from_grid(rx_cfg, card)
        assert not plain.demap_kernel
        want = ul_graph.receive(plain, *args)
        torch.cuda.synchronize()
        assert pusch_demap.LAUNCHES["pusch_demap"] == 1
    return got, want


def test_demap_kernel_receiver_equals_plain_demap(card, monkeypatch):
    """At the cell's shape the receiver, whose demap stage is the kernel
    (bit-major), gives every output of the same receiver with the plain
    demap bit for bit, in one launch of the kernel per call."""
    reqs, samples, _ = ul_slot(4, 1)
    rx_cfg, fn, _, args = receiver_args(card, reqs, samples)
    got, want = kernel_and_plain(card, monkeypatch, rx_cfg, fn, args)
    assert_equal(got, want)
    assert bool(want["tb_crc_ok"].all())


def test_demap_kernel_uci_receiver_equals_plain_demap(card, monkeypatch):
    """The same at the cell's shape with HARQ-ACK and CSI parts 1 and 2 on
    the PUSCH, where the demap stage runs symbol-major: every output,
    the UCI fields' bits and metrics too, bit for bit.  (The UE side sends
    no UCI, so the TBs need not decode.)"""
    reqs, samples, _ = ul_slot(4, 1)
    reqs = [pdus.UlTtiRequest(slot=r.slot, pusch=(dataclasses.replace(
        r.pusch[0], nof_harq_ack_bits=2, nof_csi_part1_bits=5, part2_size_map=(6,) * 32),))
        for r in reqs]
    rx_cfg, fn, _, args = receiver_args(card, reqs, samples, nof_csi2=6)
    assert args[4] is not None and all(f is not None for f in args[4])
    got, want = kernel_and_plain(card, monkeypatch, rx_cfg, fn, args)
    assert_equal(got, want)
    for k in ("harq_ack_bits", "harq_ack_metric", "csi1_bits", "csi1_metric", "csi2_bits",
              "csi2_metric"):
        assert torch.equal(got[k], want[k]), k


def test_retransmission_replay_combines_as_eager(card):
    """A first transmission that fails on every row (noise 0.04 per
    component, about 22 dB per rx port), then its rv 2 retransmission with
    the first's soft bits as HARQ input: the replayed combining equals the
    eager one bit for bit, and the soft bits it leaves are not the
    retransmission's own (the first's were combined in)."""
    reqs, samples, tbs = ul_slot(5, 2, noise=0.04)
    _, fn, _, args = receiver_args(card, reqs, samples)
    with torch.no_grad():
        first = fn(*args)
    assert not bool(first["tb_crc_ok"].any())
    reqs2, samples2, tbs2 = ul_slot(5, 2, noise=0.04, rv=2)
    assert all(np.array_equal(a, b) for a, b in zip(tbs, tbs2))
    rx_cfg2, fn2, key2, args2 = receiver_args(card, reqs2, samples2, first["harq_soft"].clone())
    with torch.no_grad():
        want = fn2(*args2)
        alone = fn2(*receiver_args(card, reqs2, samples2)[3])
    outs = replayed(rx_cfg2, fn2, key2, args2)
    assert [rec.get("ul_graph_captures", 0) for _, rec in outs] == [0, 1, 0]
    for got, _ in outs:
        assert_equal(got, want)
    assert not torch.equal(want["harq_soft"], alone["harq_soft"])


def test_fapi_entry_counts_and_repeats(card):
    """`MultiCellUpperPhy.process_ul_slot` on one slot three times: the
    captures and replays of each call, and the same indications from the
    eager, the captured and the replayed call (channel state included)."""
    phy = MultiCellUpperPhy(PHY_CELL, NCELL, device=card)
    reqs, samples, tbs = ul_slot(6, 3)
    seen = []
    for _ in range(3):
        with tracing.entry("test.fapi") as rec:
            out = phy.process_ul_slot(reqs, samples)
        seen.append((out, dict(rec)))
    assert [rec.get("ul_graph_captures", 0) for _, rec in seen] == [0, 1, 0]
    assert [rec["ul_graph_replays"] for _, rec in seen] == [0, 1, 1]
    for _, rec in seen:
        assert rec["crc_channel_states"] == NCELL and rec["pusch_cbs"] == NCELL * 76
        assert rec["ul_demap_rows"] == NCELL and rec["ul_demap_kernel_rows"] == NCELL
        assert NCELL * 76 <= rec["ldpc_sweeps"] <= NCELL * 76 * 6
    first = seen[0][0]
    for out, _ in seen[1:]:
        for c in range(NCELL):
            crc, data = out[c][0], out[c][1]
            assert isinstance(crc, CrcIndication) and isinstance(crc, pdus.CrcIndication)
            assert crc == first[c][0]
            assert np.array_equal(data.tb_bits, first[c][1].tb_bits)
            assert np.array_equal(data.tb_bits, tbs[c])
