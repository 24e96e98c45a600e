"""PyTorch port, `parallel/multi_cell_phy.MultiCellUpperPhy` against the JAX
`MultiCellUpperPhy` (the cases of tests/test_multi_cell_phy.py) and against
per-cell `UpperPhy` dispatch, on cells of 24 PRB, DFT 512, 30 kHz.

Slots are made on the host from numpy seeds with the port's transmitter
(`tests/test_torch_upper_phy.pusch_slot`); the JAX class takes the same
samples and the requests converted field by field.  The JAX class shards its
cells over the 8 virtual CPU devices, so its side runs in a fresh
interpreter (`tests/test_torch_parallel.run_isolated`).  The port runs at
world 1 with no process group, and in 2 gloo ranks on the cell axis spawned
with `torch.multiprocessing` (tests/test_torch_parallel.py holds a 2x2
("cell", "sp") mesh), which must return the world-1 results; JAX is imported
only inside functions, so those ranks never load it.

Where the port departs from JAX on purpose (the JAX faults of ROADMAP Queue
C), a test shows each: one HARQ arena per cell, so a retransmission that
changes between the batched and the per-cell path keeps its history; and
real-pair DL returns on the heterogeneous fallback.

Tolerances and why:
  * indications (CRC flags, TB bits, HARQ-ACK and CSI bits, valid flags):
    equal, field by field (`tests/test_torch_upper_phy.compare`);
  * DL float32 grids: 1e-5 absolute, samples 1e-5 relative RMS, as
    tests/test_torch_dl_slot.py holds one cell against JAX; the batched DL
    against per-cell dispatch and across world sizes: equal.
"""

import dataclasses

import numpy as np
import pytest

from srsran_projectvtlmo_tpu_torch.fapi.pdus import (
    CrcIndication, CsiRsPdu, DlTtiRequest, PdcchPdu, PdschPdu, PuschPdu, RxDataIndication,
    SsbPdu, TxDataRequest, UciIndication, UlTtiRequest)
from srsran_projectvtlmo_tpu_torch.parallel.distributed import make_ran_mesh
from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy
from srsran_projectvtlmo_tpu_torch.phy.dl_slot import get_dl_slot_program
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation

UL_CELL = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_rx_ports=1, phys_cell_id=7)
DL_CELL = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_tx_ports=2, phys_cell_id=1,
                     grid_bf16=False)
DL_CELL1 = CellConfig(nof_rb=24, dft_size=512, numerology=1, phys_cell_id=1)
QPSK, QAM16 = Modulation.QPSK, Modulation.QAM16
#: Noise per component at which a QPSK R=0.5 first transmission fails and
#: its chase-combined retransmission decodes (tests/test_torch_upper_phy).
HARQ_NOISE = 0.62
P2MAP = (4, 6, 8, 10)
GRID_TOL = 1e-5
SAMPLES_REL_RMS = 1e-5


def _pdu(**kw) -> PuschPdu:
    base = dict(rnti=0x4601, rb_start=4, rb_size=16, modulation=QAM16, target_code_rate=0.5,
                n_id=3, dmrs_symbols=(2, 11))
    return PuschPdu(**{**base, **kw})


def _slot(pdus, slot: int, seed: int, noise=None, uci=None, csi2=None, tbs=None):
    """(requests, samples (ncell, 1, nsamples, 2), TBs) of one slot, one PDU
    per cell: cell c's TB (unless `tbs` gives it) and noise from seed + 7 c."""
    from tests.test_torch_upper_phy import NOISE, modulate, place_pusch, tx_config

    samples, sent = [], []
    for c, pdu in enumerate(pdus):
        rng = np.random.default_rng(seed + 7 * c)
        tb = rng.integers(0, 2, tx_config(pdu, slot, 1).tbs).astype(np.uint8)
        if tbs is not None and tbs[c] is not None:
            tb = tbs[c]
        carrier = np.zeros((1, 14, UL_CELL.nof_subc), np.complex64)
        place_pusch(carrier, pdu, slot, tb, None if uci is None else uci[c],
                    None if csi2 is None else csi2[c])
        samples.append(modulate(carrier, slot, seed + 7 * c + 1, noise or NOISE))
        sent.append(tb)
    return [UlTtiRequest(slot=slot, pusch=(p,)) for p in pdus], np.stack(samples), sent


def ul_scenarios() -> dict:
    """name -> (ncell, [(requests, samples, TBs) per slot]), built by the port.
    The SCH scenarios share two PDU shapes (QPSK over 16 and over 8 PRB), so
    the JAX side compiles few programs."""
    qpsk16 = dict(modulation=QPSK, harq_id=3)
    qpsk8 = dict(modulation=QPSK, rb_start=0, rb_size=8)
    out = {}
    out["distinct_rnti"] = (2, [_slot([_pdu(rnti=0x101, n_id=5, **qpsk16),
                                       _pdu(rnti=0x2B67, n_id=500, **qpsk16)], 3, seed=30)])
    out["heterogeneous"] = (2, [_slot([_pdu(rnti=0x10, n_id=0, **qpsk16),
                                       _pdu(rnti=0x11, n_id=1, **qpsk8)], 0, seed=40)])
    first = [_pdu(rnti=0x111 * (c + 1), n_id=c + 1, **qpsk16) for c in range(2)]
    again = [dataclasses.replace(p, new_data=False) for p in first]
    slots = [_slot(first, 0, seed=50, noise=HARQ_NOISE)]
    slots.append(_slot(again, 2, seed=51, noise=HARQ_NOISE, tbs=slots[0][2]))
    out["harq_retx"] = (2, slots)
    # Cell 0 retransmits in a slot where cell 1's PDU has another shape: the
    # retransmission leaves the batched path for the per-cell one.
    moved = [again[0], _pdu(rnti=0x222, n_id=2, **qpsk8)]
    out["retx_changes_path"] = (2, [slots[0], _slot(moved, 2, seed=51, noise=HARQ_NOISE,
                                                    tbs=[slots[0][2][0], None])])
    csi1 = (1, 3)
    uci = [{"csi1_bits": np.array([v >> 1, v & 1], np.uint8),
            "csi2_bits": np.random.default_rng(60 + c).integers(0, 2, P2MAP[v]).astype(np.uint8)}
           for c, v in enumerate(csi1)]
    pdus = [_pdu(rnti=0x111 * (c + 1), n_id=(3, 9)[c], nof_csi_part1_bits=2,
                 part2_size_map=P2MAP) for c in range(2)]
    req, samples, tbs = _slot(pdus, 2, seed=60, uci=uci, csi2=[P2MAP[v] for v in csi1])
    out["csi_two_phase"] = (2, [(req, samples, tbs, uci)])
    return out


def dl_scenarios() -> dict:
    """name -> (cell, requests, TxDataRequests): a batch of one structure on a
    2-port float32-grid cell (SSB, PDSCH, PDCCH and CSI-RS with each cell's
    own values), and a 1-port pair of two structures (the second cell has no
    CSI-RS), which takes the per-cell fallback."""
    w = np.exp(-2j * np.pi * np.outer(np.arange(2), np.arange(2)) / 2) / np.sqrt(2)
    prec = tuple(tuple((float(c.real), float(c.imag)) for c in row) for row in w)
    out = {}
    for name, cell, ports in (("dl_batch", DL_CELL, 2), ("dl_fallback", DL_CELL1, 1)):
        reqs, datas = [], []
        for c in range(2):
            rnti = 0x4601 + c
            pdcch = PdcchPdu(rnti=rnti, nof_dci_bits=40, aggregation_level=4, cce_index=0,
                             start_symbol=0, n_id=c, n_rnti=rnti, coreset_nof_rb=24)
            object.__setattr__(pdcch, "payload", tuple(
                int(b) for b in np.random.default_rng(70 + c).integers(0, 2, 40)))
            pdsch = PdschPdu(rnti=rnti, rb_start=2, rb_size=20, modulation=QAM16,
                             target_code_rate=0.5, nof_layers=ports, start_symbol=2,
                             nof_symbols=12, dmrs_symbols=(2,), n_id=c + 1,
                             precoding=prec if ports == 2 else None)
            csi = () if (name == "dl_fallback" and c == 1) else (
                CsiRsPdu(nof_rb=24, symbol=13, subcarrier_offset=3, scrambling_id=c),)
            req = DlTtiRequest(slot=3, pdcch=(pdcch,), pdsch=(pdsch,), csi_rs=csi,
                               ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=c,
                                           half_radio_frame=False),))
            tbs = get_dl_slot_program(req, cell, "cpu").pdsch_cfgs[0].tbs
            reqs.append(req)
            datas.append(TxDataRequest(slot=3, tb_bits=[
                np.random.default_rng(80 + c).integers(0, 2, tbs).astype(np.uint8)]))
        out[name] = (cell, reqs, datas)
    return out


# ------------------------------------------------------ the three sides --

def port_run(world: int, payload) -> dict:
    """Every scenario through the port's MultiCellUpperPhy on the CPU: at
    world 1 with no group, or in a gloo group of `world` ranks (cell axis 2,
    sp the rest)."""
    ul, dl = payload
    rmesh = make_ran_mesh(2, world // 2, device="cpu") if world > 1 else None
    res = {}
    for name, (ncell, slots) in ul.items():
        phy = MultiCellUpperPhy(UL_CELL, ncell, rmesh, device="cpu")
        res[name] = [phy.process_ul_slot(s[0], s[1]) for s in slots]
    for name, (cell, reqs, datas) in dl.items():
        phy = MultiCellUpperPhy(cell, len(reqs), rmesh, device="cpu")
        grid, samples = phy.process_dl_slot(reqs, datas)
        res[name] = (grid.float().numpy(), samples.numpy(),
                     phy.process_dl_slot(reqs, datas, fetch=True))
    return res


def per_cell_run(ul: dict) -> dict:
    """Every UL scenario through one plain `UpperPhy` per cell."""
    res = {}
    for name, (ncell, slots) in ul.items():
        phys = [UpperPhy(UL_CELL, device="cpu") for _ in range(ncell)]
        res[name] = [[phys[c].process_ul_slot(s[0][c], s[1][c]) for c in range(ncell)]
                     for s in slots]
    return res


def jax_run(payload) -> dict:
    """Every scenario through the JAX MultiCellUpperPhy on its default mesh
    of the 8 virtual CPU devices (2 cell x 4 sp); run in a fresh
    interpreter."""
    from srsran_projectvtlmo_tpu.parallel.multi_cell_phy import MultiCellUpperPhy as JaxMulti
    from tests.test_torch_dl_slot import to_jax_request
    from tests.test_torch_upper_phy import to_jax

    ul, dl = payload
    res = {}
    for name, (ncell, slots) in ul.items():
        phy = JaxMulti(to_jax(UL_CELL), ncell)
        res[name] = [phy.process_ul_slot([to_jax(r) for r in s[0]], s[1]) for s in slots]
    for name, (cell, reqs, datas) in dl.items():
        phy = JaxMulti(to_jax(cell), len(reqs))
        grid, samples = phy.process_dl_slot([to_jax_request(r) for r in reqs],
                                            [to_jax(d) for d in datas], fetch=True)
        res[name] = (np.asarray(grid), np.asarray(samples))
    return res


@pytest.fixture(scope="module")
def inputs():
    return ul_scenarios(), dl_scenarios()


@pytest.fixture(scope="module")
def world1(inputs):
    return port_run(1, inputs)


@pytest.fixture(scope="module")
def jax_future(inputs):
    from tests.test_torch_parallel import isolated_future

    return isolated_future("tests.test_torch_multi_cell_phy:jax_run", inputs)


@pytest.fixture(scope="module")
def jax_side(jax_future):
    return jax_future.result()


def _of(inds, cls):
    """The indications of one class, the port's or the JAX package's."""
    return [i for i in inds if type(i).__name__ == cls.__name__]


def _decoded(inds, tb) -> bool:
    crc = _of(inds, CrcIndication)
    return bool(crc[0].tb_crc_ok) and np.array_equal(_of(inds, RxDataIndication)[0].tb_bits, tb)


# ---------------------------------------------------------------- tests --

def test_cell_axis_of_two_gloo_ranks_equals_world1(inputs, world1, jax_future):
    """Two ranks on the cell axis, one cell each: every rank returns every
    cell's world-1 indications and DL tensors.  First in the file, so that
    the JAX side (`jax_future`) runs beside the ranks."""
    from tests.test_torch_parallel import run_ranks
    from tests.test_torch_upper_phy import compare

    for res in run_ranks(2, "tests.test_torch_multi_cell_phy:port_run", inputs):
        for name, want in world1.items():
            if name.startswith("dl_"):
                for g, w in zip(res[name][:2], want[:2]):
                    np.testing.assert_array_equal(g, w, err_msg=name)
                continue
            for k, slot in enumerate(want):
                for c, inds in enumerate(slot):
                    compare(inds, res[name][k][c])


@pytest.mark.parametrize("name", ["distinct_rnti", "heterogeneous", "harq_retx",
                                  "csi_two_phase"])
def test_ul_matches_jax_and_per_cell_dispatch(inputs, world1, jax_side, name):
    """The multi-cell indications equal the JAX class's and per-cell
    dispatch's, slot by slot and cell by cell."""
    from tests.test_torch_upper_phy import compare

    ncell, slots = inputs[0][name]
    per_cell = per_cell_run({name: inputs[0][name]})[name]
    for k in range(len(slots)):
        got = world1[name][k]
        assert len(got) == ncell
        for c in range(ncell):
            compare(jax_side[name][k][c], got[c])
            compare(per_cell[k][c], got[c])


def test_distinct_rntis_decode_in_one_receiver_call(inputs, world1, monkeypatch):
    """Cells with distinct rnti and n_id: every TB decodes, and the batched
    path makes one receiver call on all their rows (the shared PUSCH
    dispatch looks the receiver up in `phy.upper_phy`)."""
    import srsran_projectvtlmo_tpu_torch.phy.upper_phy as up

    reqs, samples, tbs = inputs[0]["distinct_rnti"][1][0]
    for c, tb in enumerate(tbs):
        assert _decoded(world1["distinct_rnti"][0][c], tb), c
        assert _of(world1["distinct_rnti"][0][c], CrcIndication)[0].rnti == reqs[c].pusch[0].rnti
    rows, cached = [], up.cached_pusch_rx_from_grid

    def counting(cfg, device):
        rx = cached(cfg, device)
        return lambda grid, *args: rows.append(grid.shape[0]) or rx(grid, *args)

    monkeypatch.setattr(up, "cached_pusch_rx_from_grid", counting)
    MultiCellUpperPhy(UL_CELL, len(reqs), device="cpu").process_ul_slot(reqs, samples)
    assert rows == [len(reqs)]


def test_heterogeneous_shapes_fall_back_and_decode(inputs, world1):
    _, slots = inputs[0]["heterogeneous"]
    for c, tb in enumerate(slots[0][2]):
        assert _decoded(world1["heterogeneous"][0][c], tb), c


def test_harq_retransmission_combines_in_the_batch(inputs, world1):
    """A first transmission too noisy to decode, then its retransmission in
    the same batch: only the combined soft bits decode; one arena per cell,
    released after the pass."""
    _, slots = inputs[0]["harq_retx"]
    first, again = world1["harq_retx"]
    assert not any(_of(inds, CrcIndication)[0].tb_crc_ok for inds in first)
    for c, tb in enumerate(slots[1][2]):
        assert _decoded(again[c], tb), c
    phy = MultiCellUpperPhy(UL_CELL, 2, device="cpu")
    assert all(phy.harq_pools[c] is phy.cell_phys[c].harq_pool for c in range(2))
    for reqs, samples, _ in slots:
        phy.process_ul_slot(reqs, samples)
    assert [p.nof_reserved for p in phy.harq_pools] == [0, 0]


def test_csi_two_phase_buckets(inputs, world1):
    """Two cells whose decoded CSI part 1 selects different part-2 sizes:
    both part-2 payloads and both TBs come back."""
    _, slots = inputs[0]["csi_two_phase"]
    _, _, tbs, uci = slots[0]
    for c in range(2):
        inds = world1["csi_two_phase"][0][c]
        assert _decoded(inds, tbs[c])
        u = _of(inds, UciIndication)[0]
        assert u.csi1_valid and u.csi2_valid
        np.testing.assert_array_equal(u.csi1_bits, uci[c]["csi1_bits"])
        np.testing.assert_array_equal(u.csi2_bits, uci[c]["csi2_bits"])
    assert len({len(uci[c]["csi2_bits"]) for c in range(2)}) == 2


def test_retransmission_that_changes_path_keeps_its_history(inputs, world1, jax_side):
    """JAX fault 1 (ROADMAP Queue C): cell 0's first transmission goes
    through the batched path, its retransmission through the per-cell path.
    The port's one arena per cell combines them and decodes, as per-cell
    dispatch does; the JAX class decodes the retransmission against the
    per-cell UpperPhy's empty arena and fails."""
    _, slots = inputs[0]["retx_changes_path"]
    tb = slots[1][2][0]
    first, moved = world1["retx_changes_path"]
    assert not _of(first[0], CrcIndication)[0].tb_crc_ok
    assert _decoded(moved[0], tb)
    assert _decoded(per_cell_run({"x": inputs[0]["retx_changes_path"]})["x"][1][0], tb)
    assert not _of(jax_side["retx_changes_path"][1][0], CrcIndication)[0].tb_crc_ok


def test_dl_batch_matches_per_cell_and_jax(inputs, world1, jax_side):
    """One batched DL call for two cells equals per-cell `process_dl_slot`
    bit for bit and the JAX class within tests/test_torch_dl_slot.py's
    tolerances; fetch=True gives the same values as float32 numpy."""
    cell, reqs, datas = inputs[1]["dl_batch"]
    grid, samples, (fgrid, fsamples) = world1["dl_batch"]
    assert grid.shape == (2, 2, 14, cell.nof_subc, 2) and samples.shape[:2] == (2, 2)
    phy = UpperPhy(cell, device="cpu")
    for c in range(2):
        g, s = phy.process_dl_slot(reqs[c], datas[c], fetch=False)
        np.testing.assert_array_equal(grid[c], g.numpy())
        np.testing.assert_array_equal(samples[c], s.numpy())
    np.testing.assert_array_equal(fgrid, grid)
    np.testing.assert_array_equal(fsamples, samples)
    jgrid, jsamples = jax_side["dl_batch"]
    np.testing.assert_allclose(grid, jgrid, atol=GRID_TOL)
    err = np.sqrt(np.mean((samples - jsamples) ** 2) / np.mean(jsamples ** 2))
    assert err < SAMPLES_REL_RMS, err


def test_dl_fallback_returns_real_pairs(inputs, world1, jax_side):
    """JAX fault 2 (ROADMAP Queue C): the heterogeneous fallback.  The port
    returns the batched path's layout, real pairs (ncell, P, 14, nsubc, 2)
    and (ncell, P, nsamples, 2), with the per-cell values; the JAX class
    stacks complex grids with the port axis squeezed for a 1-port cell."""
    cell, reqs, datas = inputs[1]["dl_fallback"]
    grid, samples, (fgrid, fsamples) = world1["dl_fallback"]
    assert fgrid.shape == (2, 1, 14, cell.nof_subc, 2) and fgrid.dtype == np.float32
    assert fsamples.shape[:2] == (2, 1) and fsamples.shape[-1] == 2
    jgrid, jsamples = jax_side["dl_fallback"]
    assert jgrid.shape == (2, 14, cell.nof_subc) and np.iscomplexobj(jgrid)
    phy = UpperPhy(cell, device="cpu")
    for c in range(2):
        g, s = phy.process_dl_slot(reqs[c], datas[c])
        np.testing.assert_array_equal(fgrid[c, 0, ..., 0] + 1j * fgrid[c, 0, ..., 1], g)
        np.testing.assert_array_equal(fsamples[c, 0], s)
        np.testing.assert_allclose(g, jgrid[c], atol=np.abs(jgrid).max() * 2 ** -8)
