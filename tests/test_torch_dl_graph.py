"""PyTorch port, the DL slot program's CUDA graphs on the card: replays equal
the eager `_assemble` bit for bit, returned tensors are the caller's own,
the `dl_graph_captures` / `dl_graph_replays` counters, the cap on replay
keys, and replays from several threads.

Every test needs an NVIDIA card and skips without one.  This file imports no
JAX, so it runs where the card is, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dl_graph.py
"""

import threading

import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu_torch.fapi.pdus import (
    CsiRsPdu, DlTtiRequest, PdcchPdu, PdschPdu, SsbPdu, TxDataRequest)
from srsran_projectvtlmo_tpu_torch.phy import dl_slot
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation
from srsran_projectvtlmo_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

#: The benchmark's cell: 100 MHz, 30 kHz SCS, 4 tx ports, bf16 grid.
CELL = CellConfig(nof_rb=273, dft_size=4096, numerology=1, phys_cell_id=1, nof_tx_ports=4,
                  nof_rx_ports=4, grid_bf16=True)
#: The 4x2 DFT precoder as the PDU's ((re, im), ...) rows.
W42 = tuple(tuple((float(c.real), float(c.imag)) for c in row)
            for row in np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2)) / 4) / 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the DL slot's CUDA graphs exist only there")
    return torch.device("cuda", torch.cuda.current_device())


def request(slot: int, seed: int, rv: int = 0) -> tuple[DlTtiRequest, TxDataRequest]:
    """A north-star DL slot (2-layer QAM256 PDSCH on 273 PRB, PDCCH, SSB,
    CSI-RS) with the seed's UE, DCI and TB."""
    rng = np.random.default_rng(seed)
    rnti, n_id = int(rng.integers(1, 65520)), int(rng.integers(0, 1008))
    pdcch = PdcchPdu(rnti=rnti, n_id=n_id, n_rnti=rnti, nof_dci_bits=40, aggregation_level=4,
                     cce_index=0, start_symbol=1, coreset_nof_rb=48, interleaved=True)
    object.__setattr__(pdcch, "payload", tuple(int(b) for b in rng.integers(0, 2, 40)))
    pdsch = PdschPdu(rnti=rnti, rb_start=0, rb_size=273, modulation=Modulation.QAM256,
                     target_code_rate=948 / 1024, nof_layers=2, start_symbol=2, nof_symbols=12,
                     dmrs_symbols=(2,), n_id=n_id, rv=rv, precoding=W42)
    req = DlTtiRequest(
        slot=slot, pdcch=(pdcch,), pdsch=(pdsch,),
        ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=int(rng.integers(0, 1024)),
                    half_radio_frame=False),),
        csi_rs=(CsiRsPdu(nof_rb=273, symbol=13, subcarrier_offset=3, scrambling_id=n_id),))
    tbs = dl_slot.get_dl_slot_program(req, CELL, "cpu").pdsch_cfgs[0].tbs
    return req, TxDataRequest(slot=slot, tb_bits=[rng.integers(0, 2, tbs).astype(np.uint8)])


def fresh_program(card) -> dl_slot.DlSlotProgram:
    """A program of the north-star structure with no replay key seen yet."""
    return dl_slot.DlSlotProgram(dl_slot.plan_key_for(request(0, 0)[0], CELL), CELL, card)


def stacked_batch(program, slot: int, seeds, rv: int = 0):
    args = []
    for seed in seeds:
        req, data = request(slot, seed, rv)
        values = dl_slot.build_dl_slot_inputs(program, req, data, slot)
        args.append(program.value_args(req, values))
    return program.stack_values(args)


def counted_run(program, slot: int, stacked):
    """`run_stacked` inside a FAPI entry: (outputs, the call's counter record)."""
    with tracing.entry("test.dl_graph") as rec:
        out = program.run_stacked(slot, stacked)
    torch.cuda.synchronize()
    return out, rec


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("rv", [0, 2])
@pytest.mark.parametrize("slot", [4, 5])
def test_graph_replay_equals_eager(card, slot, rv, b):
    """Both OFDM phases, rv 0 and 2, one slot and a batch of four (values
    stacked anew for the last call): the replay's grid and samples are the
    eager ones, bit for bit; the key's first call runs eagerly, its second
    captures."""
    program = fresh_program(card)
    stacked = stacked_batch(program, slot, range(10 * b, 11 * b), rv)
    with torch.no_grad():
        want = program._assemble(slot % 2, *stacked)
    for call in range(3):
        (grid, samples), rec = counted_run(program, slot, stacked)
        assert rec.get("dl_graph_captures", 0) == (call == 1)
        assert rec["dl_graph_replays"] == (call > 0)
        assert torch.equal(grid, want[0]) and torch.equal(samples, want[1])
    args = [program.value_args(*_values(program, slot, seed, rv)) for seed in range(20, 20 + b)]
    grid, samples = program.run_stacked(slot, program.stack_values(args))
    with torch.no_grad():
        want = program._assemble(slot % 2, *program.stack_values(args))
    assert torch.equal(grid, want[0]) and torch.equal(samples, want[1])


def test_replay_of_inputs_from_separate_tensors(card):
    """Inputs that are not views of one upload per dtype are copied into the
    graph array by array, with the same outputs."""
    program = fresh_program(card)
    for seed in range(2):
        program.run_stacked(4, stacked_batch(program, 4, [seed]))
    stacked = stacked_batch(program, 4, [7])
    apart = dl_slot._replace_arrays(stacked, iter([a.clone() for a in dl_slot._arrays(stacked)]))
    assert dl_slot._tiled_base(dl_slot._arrays(apart)[:1]) is None
    (grid, samples), rec = counted_run(program, 4, apart)
    assert rec["dl_graph_replays"] == 1
    with torch.no_grad():
        want = program._assemble(0, *stacked)
    assert torch.equal(grid, want[0]) and torch.equal(samples, want[1])


def _values(program, slot: int, seed: int, rv: int):
    req, data = request(slot, seed, rv)
    return req, dl_slot.build_dl_slot_inputs(program, req, data, slot)


def test_fetch_false_outputs_are_not_graph_memory(card):
    """Two `fetch=False` calls back to back on one program's graph: the
    first call's tensors are unchanged by the second."""
    phy = UpperPhy(CELL, device=card)
    for seed in range(2):  # the key's eager call and its capture
        phy.process_dl_slot(*request(6, seed), fetch=False)
    g1, s1 = phy.process_dl_slot(*request(6, 2), fetch=False)
    g1_copy, s1_copy = g1.clone(), s1.clone()
    g2, s2 = phy.process_dl_slot(*request(6, 3), fetch=False)
    torch.cuda.synchronize()
    assert torch.equal(g1, g1_copy) and torch.equal(s1, s1_copy)
    assert not torch.equal(g1, g2) and not torch.equal(s1, s2)


def test_counters_and_key_cap(card):
    """One capture per key, one replay per later call; a ninth key evicts
    the least recently used, whose next call is eager again."""
    program = fresh_program(card)
    keys = [(slot, rv, 1) for rv in range(4) for slot in (4, 5)] + [(4, 0, 2)]
    captures = replays = 0
    for slot, rv, b in keys:
        stacked = stacked_batch(program, slot, range(b), rv)
        for _ in range(3):
            _, rec = counted_run(program, slot, stacked)
            captures += rec.get("dl_graph_captures", 0)
            replays += rec["dl_graph_replays"]
    assert (captures, replays) == (len(keys), 2 * len(keys))
    assert len(program._graphs) == dl_slot.GRAPH_KEYS
    slot, rv, b = keys[0]
    stacked = stacked_batch(program, slot, range(b), rv)
    counts = []
    for _ in range(3):
        _, rec = counted_run(program, slot, stacked)
        counts.append((rec.get("dl_graph_captures", 0), rec["dl_graph_replays"]))
    assert counts == [(0, 0), (1, 1), (0, 1)]


def test_replays_from_threads(card):
    """Four threads replay the two OFDM phases' graphs of one program, each
    call checked bit for bit against the eager outputs."""
    program = fresh_program(card)
    inputs = {slot: stacked_batch(program, slot, [slot]) for slot in (4, 5)}
    with torch.no_grad():
        want = {slot: program._assemble(slot % 2, *st) for slot, st in inputs.items()}
    for slot, st in inputs.items():
        for _ in range(2):
            program.run_stacked(slot, st)
    bad, errors = [], []

    def worker(k: int):
        try:
            for i in range(10):
                slot = 4 + (k + i) % 2
                grid, samples = program.run_stacked(slot, inputs[slot])
                torch.cuda.current_stream().synchronize()
                if not (torch.equal(grid, want[slot][0]) and torch.equal(samples, want[slot][1])):
                    bad.append((k, i))
        except Exception as exc:  # reported below: a thread's failure fails the test
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and bad == []
