"""PyTorch port, the DL FAPI entry point against the JAX package:
`UpperPhy(cell, device="cpu").process_dl_slot` and the JAX
`UpperPhy.process_dl_slot` on identical `DlTtiRequest`s and TB bits, the
cases of tests/test_dl_slot.py and tests/test_bf16_grid.py at <= 52 PRB:
4x2 precoding, interleaved PDCCH, CSI-RS rows and density 0.5, CSI-RS inside
the PDSCH and a CORESET reservation with PDCCH, rv 0-3, UE churn on one
plan, the bf16 grid, and a batch through `upper_phy.dl_slot_on_device`
against per-slot calls; on a CPU device `run_stacked` is the eager
`_assemble` and keeps no CUDA graph (the card's side:
tests/test_torch_dl_graph.py).

Tolerances and why:
  * float32 grids: 1e-5 absolute (precoding products summed in another
    order; the values are otherwise the same float32 operations);
  * bf16 grids: 2^-8 of the grid's peak per RE against the float32 grid
    (bf16 keeps 8 mantissa bits), the bound of
    tests/test_bf16_grid.py::test_dl_bf16_grid_parity;
  * samples: 1e-5 relative RMS (the inverse FFT summed in another order);
  * decoded DCI and TB bits, CRC flags, plan counts: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.phy import upper_phy as jax_upper_phy
from srsran_projectvtlmo_tpu.ran import re_pattern as jax_re_pattern

from srsran_projectvtlmo_tpu_torch.fapi.pdus import (
    CsiRsPdu, DlTtiRequest, PdcchPdu, PdschPdu, SsbPdu, TxDataRequest)
from srsran_projectvtlmo_tpu_torch.phy import dl_slot
from srsran_projectvtlmo_tpu_torch.phy import pdcch as pdcch_mod
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import (
    CellConfig, FapiValidationError, UpperPhy, dl_slot_on_device)
from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation
from srsran_projectvtlmo_tpu_torch.ran.re_pattern import coreset_pattern, csi_rs_patterns
from srsran_projectvtlmo_tpu_torch.utils import tables, tracing
from srsran_projectvtlmo_tpu_torch.utils.tables import upload_many
from tests.test_torch_upper_phy import to_jax

CELL4 = CellConfig(nof_rb=52, dft_size=1024, numerology=1, phys_cell_id=1, nof_tx_ports=4,
                   nof_rx_ports=4, grid_bf16=False)
CELL1 = CellConfig(nof_rb=24, dft_size=512, numerology=1, grid_bf16=False)
GRID_TOL = 1e-5
SAMPLES_REL_RMS = 1e-5


def pairs(w: np.ndarray):
    """A complex matrix or vector as the FAPI PDUs' nested (re, im) tuples."""
    if w.ndim == 1:
        return tuple((float(c.real), float(c.imag)) for c in w)
    return tuple(pairs(row) for row in w)


#: The north-star DL precoder, the 4x2 DFT matrix.
W42 = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(2)) / 4) / 2


def with_payload(pdu: PdcchPdu, payload: np.ndarray):
    """The PDU carrying its DCI bits (the attribute the DL slot reads)."""
    object.__setattr__(pdu, "payload", tuple(int(b) for b in payload))
    return pdu


def to_jax_request(req: DlTtiRequest):
    """The request as the JAX package's, reserved RE patterns and DCI bits
    included."""
    jreq = to_jax(dataclasses.replace(req, pdsch=tuple(
        dataclasses.replace(p, reserved=()) for p in req.pdsch)))
    jreq = dataclasses.replace(jreq, pdsch=tuple(
        dataclasses.replace(j, reserved=tuple(jax_re_pattern.RePattern(**dataclasses.asdict(r))
                                              for r in p.reserved))
        for p, j in zip(req.pdsch, jreq.pdsch)))
    for pdu, jpdu in zip(req.pdcch, jreq.pdcch):
        if getattr(pdu, "payload", None) is not None:
            with_payload(jpdu, pdu.payload)
    return jreq


def tx_data(req: DlTtiRequest, cell: CellConfig, seed: int) -> TxDataRequest:
    rng = np.random.default_rng(seed)
    program = dl_slot.get_dl_slot_program(req, cell, "cpu")
    return TxDataRequest(slot=req.slot, tb_bits=[rng.integers(0, 2, cfg.tbs).astype(np.uint8)
                                                 for cfg in program.pdsch_cfgs])


def run_both(cell: CellConfig, req: DlTtiRequest, seed: int = 0, phy=None):
    """(port grid, port samples, JAX grid, JAX samples) of one request, the
    grid and samples held to this file's tolerances."""
    data = tx_data(req, cell, seed) if req.pdsch else None
    grid, samples = (phy or UpperPhy(cell, device="cpu")).process_dl_slot(req, data)
    jgrid, jsamples = jax_upper_phy.UpperPhy(to_jax(cell)).process_dl_slot(
        to_jax_request(req), None if data is None else to_jax(data))
    assert grid.dtype == np.complex64 and samples.dtype == np.float32
    assert grid.shape == jgrid.shape and samples.shape == jsamples.shape
    np.testing.assert_allclose(grid, jgrid, atol=GRID_TOL)
    err = np.sqrt(np.mean((samples - jsamples) ** 2) / np.mean(jsamples ** 2))
    assert err < SAMPLES_REL_RMS, err
    return grid, samples, jgrid, jsamples


def pdsch(**kw) -> PdschPdu:
    base = dict(rnti=0x44, rb_start=4, rb_size=16, modulation=Modulation.QAM16,
                target_code_rate=0.5, nof_layers=2, start_symbol=1, nof_symbols=12,
                dmrs_symbols=(3,), n_id=7, precoding=pairs(W42))
    return PdschPdu(**{**base, **kw})


def test_4port_2layer_precoding_matches_jax():
    grid, _, _, _ = run_both(CELL4, DlTtiRequest(slot=2, pdsch=(pdsch(),)))
    assert grid.shape == (4, 14, CELL4.nof_subc)
    # The DM-RS symbol: both layers on CDM group 0 (even subcarriers only).
    k0 = 4 * 12
    assert np.abs(grid[:, 3, k0 + 1:k0 + 16 * 12:2]).max() == 0
    assert np.abs(grid[:, 3, k0:k0 + 16 * 12:2]).max() > 0.5


def test_4_layers_use_both_cdm_groups():
    w = (np.random.default_rng(2).normal(size=(4, 4))
         + 1j * np.random.default_rng(3).normal(size=(4, 4))) / 4
    grid, _, _, _ = run_both(CELL4, DlTtiRequest(slot=5, pdsch=(pdsch(
        nof_layers=4, modulation=Modulation.QAM64, precoding=pairs(w), dmrs_symbols=(3, 10)),)))
    assert np.abs(grid[:, 3, 4 * 12 + 1:20 * 12:2]).min() > 0


def test_precoding_shape_rejected():
    """A precoding matrix of the wrong shape raises, as in JAX."""
    bad = pdsch(rb_start=0, rb_size=4, modulation=Modulation.QPSK, target_code_rate=0.3,
                nof_layers=2, precoding=(((1.0, 0.0),),))
    with pytest.raises(AssertionError):
        UpperPhy(CELL4, device="cpu").process_dl_slot(DlTtiRequest(slot=0, pdsch=(bad,)), None)


def test_interleaved_pdcch_matches_jax_and_decodes():
    """The candidate's interleaved REGs land where JAX puts them, and the
    port's blind decoder gets the DCI back from the port's grid."""
    payload = np.random.default_rng(1).integers(0, 2, 32).astype(np.uint8)
    pdu = with_payload(PdcchPdu(
        rnti=0x77, nof_dci_bits=32, aggregation_level=2, cce_index=1, start_symbol=0, n_id=1,
        n_rnti=0x77, coreset_rb_start=2, coreset_nof_rb=48, interleaved=True,
        reg_bundle_size=6, interleaver_size=2, shift_index=5), payload)
    grid, _, _, _ = run_both(CELL4, DlTtiRequest(slot=1, pdcch=(pdu,)))
    prbs, data_idx, _ = dl_slot._pdcch_plan(pdu, CELL4)
    assert sorted(prbs) != list(range(2 + 6, 2 + 18))
    re = grid[0].reshape(-1)[data_idx]
    pair = torch.as_tensor(np.stack([re.real, re.imag], -1).astype(np.float32)[None])
    bits, ok = pdcch_mod.pdcch_blind_decode(
        pair, torch.full((1, len(re)), 0.01), pdcch_mod.PdcchCandidateConfig(
            nof_dci_bits=32, aggregation_level=2, rnti=0x77, n_id=1, n_rnti=0x77))
    assert bool(ok[0])
    np.testing.assert_array_equal(bits[0].numpy(), payload)


@pytest.mark.parametrize("csi", [
    CsiRsPdu(nof_rb=52, prb_start=0, symbol=5, subcarrier_offset=3, scrambling_id=41),
    CsiRsPdu(nof_rb=24, prb_start=3, row=1, k_ref=(1,), symbol=6, density="three",
             scrambling_id=9),
    CsiRsPdu(nof_rb=30, prb_start=3, row=2, k_ref=(5,), symbol=6, density="dot5_even"),
    CsiRsPdu(nof_rb=30, prb_start=4, row=3, k_ref=(4,), symbol=8, density="dot5_odd",
             scrambling_id=1023),
    CsiRsPdu(nof_rb=52, row=4, k_ref=(2,), symbol=9, scrambling_id=7),
    CsiRsPdu(nof_rb=20, prb_start=10, row=5, k_ref=(6,), symbol=11, scrambling_id=3),
], ids=["row2", "row1_three", "row2_dot5_even", "row3_dot5_odd", "row4", "row5"])
def test_csi_rs_rows_match_jax(csi):
    run_both(CELL4, DlTtiRequest(slot=6, csi_rs=(csi,)))


def test_all_channels_4port_match_jax():
    """Precoded PDCCH and SSB, CSI-RS row 4 and a 2-layer PDSCH that the SSB
    and the CSI-RS overlap: the grid holds their sums, as in JAX."""
    rng = np.random.default_rng(5)
    wv = (rng.normal(size=4) + 1j * rng.normal(size=4)) / 2
    ws = (rng.normal(size=4) + 1j * rng.normal(size=4)) / 2
    req = DlTtiRequest(
        slot=3,
        pdcch=(PdcchPdu(rnti=0x55, nof_dci_bits=24, aggregation_level=2, cce_index=0,
                        start_symbol=1, n_id=3, n_rnti=0x55, coreset_nof_rb=48, interleaved=True,
                        precoding=pairs(wv)),),
        ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=0, half_radio_frame=False,
                    ssb_offset_pointa=2, precoding=pairs(ws)),),
        pdsch=(pdsch(rb_start=0, rb_size=52, start_symbol=2, nof_symbols=12, dmrs_symbols=(2,),
                     modulation=Modulation.QAM256, target_code_rate=0.8),),
        csi_rs=(CsiRsPdu(nof_rb=52, symbol=13, row=4, k_ref=(2,), scrambling_id=7),))
    cell = dataclasses.replace(CELL4, ssb_subc_offset=6)
    grid, _, _, _ = run_both(cell, req, seed=5)
    assert dl_slot.get_dl_slot_program(req, cell, "cpu").key.ssb_k0 == (30,)


def test_csi_rs_inside_pdsch_matches_jax():
    """The PDSCH rate-matches around CSI-RS REs inside its allocation; the
    pilots land intact."""
    csi = CsiRsPdu(nof_rb=24, prb_start=4, row=1, k_ref=(1,), symbol=5, density="three",
                   scrambling_id=9)
    from srsran_projectvtlmo_tpu_torch.ops.csi_rs import CsiRsConfig, csi_rs_pattern

    cfg = CsiRsConfig(nof_rb=24, prb_start=4, row=1, k_ref=(1,), symbol=5, density="three",
                      scrambling_id=9, slot=3)
    cell = dataclasses.replace(CELL1, nof_rb=52, dft_size=1024)
    req = DlTtiRequest(slot=3, csi_rs=(csi,), pdsch=(pdsch(
        rnti=0x77, rb_size=24, nof_layers=1, start_symbol=2, dmrs_symbols=(3,), n_id=5,
        precoding=None, reserved=csi_rs_patterns(cfg)),))
    program = dl_slot.get_dl_slot_program(req, cell, "cpu")
    assert program.pdsch_cfgs[0].nof_data_re == 24 * 12 * 11 - 24 * 3
    grid, _, _, _ = run_both(cell, req, seed=7)
    symbols, subc, vals = csi_rs_pattern(cfg)[0]
    np.testing.assert_allclose(grid[int(symbols[0]), subc], vals[0], atol=1e-6)


def test_coreset_reservation_with_pdcch_matches_jax():
    """A PDSCH over the CORESET's symbols rate-matches around its whole RBs;
    the PDCCH candidate there carries no PDSCH data."""
    cell = dataclasses.replace(CELL1, nof_rb=52, dft_size=1024)
    pdcch = PdcchPdu(rnti=0x31, nof_dci_bits=40, aggregation_level=4, cce_index=0,
                     start_symbol=0, duration=2, coreset_rb_start=0, coreset_nof_rb=24, n_id=1,
                     n_rnti=0x31)
    req = DlTtiRequest(slot=2, pdcch=(pdcch,), pdsch=(pdsch(
        rnti=0x31, rb_start=0, rb_size=30, modulation=Modulation.QPSK, target_code_rate=0.4,
        nof_layers=1, start_symbol=0, nof_symbols=14, dmrs_symbols=(2,), n_id=3, precoding=None,
        reserved=(coreset_pattern(rb_begin=0, rb_end=24, start_symbol=0, duration=2),)),))
    cfg = dl_slot.get_dl_slot_program(req, cell, "cpu").pdsch_cfgs[0]
    assert cfg.nof_subc * len(cfg.data_symbols) - cfg.nof_data_re == 24 * 12 * 2
    grid, _, _, _ = run_both(cell, req, seed=9)
    assert np.abs(grid[0, 24 * 12:30 * 12]).min() > 0.0
    _, data_idx, _ = dl_slot._pdcch_plan(pdcch, cell)
    pdcch_syms = pdcch_mod.pdcch_modulate(pdcch_mod.PdcchCandidateConfig(
        nof_dci_bits=40, aggregation_level=4, rnti=0x31, n_id=1, n_rnti=0x31),
        np.zeros(40, np.uint8))
    np.testing.assert_allclose(grid.reshape(-1)[data_idx], pdcch_syms, atol=1e-6)


def _ue(rnti, rv=0, n_id=3, prec=None) -> PdschPdu:
    return PdschPdu(rnti=rnti, rb_start=0, rb_size=8, modulation=Modulation.QPSK,
                    target_code_rate=0.4, nof_layers=1, start_symbol=1, nof_symbols=12,
                    dmrs_symbols=(3,), n_id=n_id, rv=rv, precoding=prec)


@pytest.mark.parametrize("rv", range(4))
def test_rv_values_match_jax(rv):
    run_both(CELL1, DlTtiRequest(slot=0, pdsch=(_ue(0x77, rv),)), seed=2)


def test_ue_churn_uses_one_plan():
    """rnti, n_id, rv and the precoding weights are values: five UEs and
    redundancy versions go through one DL plan and its index tables, and
    each grid still equals JAX's."""
    cell = dataclasses.replace(CELL1, nof_tx_ports=2)
    phy = UpperPhy(cell, device="cpu")
    before = dl_slot._cached_program.cache_info().misses
    plans, grids = set(), []
    for i, (rnti, rv, n_id) in enumerate([(0x10, 0, 3), (0x22, 0, 9), (0x10, 2, 3),
                                          (0x31, 0, 500), (0x44, 3, 1)]):
        w = np.exp(1j * np.array([[0.3 * i], [1.1 + i]]))
        req = DlTtiRequest(slot=i, pdsch=(_ue(rnti, rv, n_id, pairs(w)),))
        plans.add(id(dl_slot.get_dl_slot_program(req, cell, "cpu")))
        grids.append(run_both(cell, req, seed=i, phy=phy)[0])
    assert len(plans) == 1
    assert dl_slot._cached_program.cache_info().misses - before == 1
    assert not np.allclose(grids[0], grids[1]) and not np.allclose(grids[0], grids[2])


def test_bf16_grid_within_bound():
    """The default bf16 grid against the float32 grid of the port and of JAX:
    2^-8 of the peak per RE; the samples' EVM penalty < 0.5%, as
    tests/test_bf16_grid.py holds the JAX DL slot."""
    w = np.exp(-2j * np.pi * np.outer(np.arange(2), np.arange(2)) / 2) / np.sqrt(2)
    req = DlTtiRequest(
        slot=1,
        ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=0, half_radio_frame=False),),
        pdsch=(PdschPdu(rnti=0x4601, rb_start=2, rb_size=20, modulation=Modulation.QAM256,
                        target_code_rate=0.8, nof_layers=2, start_symbol=2, nof_symbols=12,
                        dmrs_symbols=(2,), precoding=pairs(w)),))
    cell16 = CellConfig(nof_rb=24, dft_size=512, numerology=1, nof_tx_ports=2)
    assert cell16.grid_bf16
    cell32 = dataclasses.replace(cell16, grid_bf16=False)
    data = tx_data(req, cell16, 9)
    g16, s16 = UpperPhy(cell16, device="cpu").process_dl_slot(req, data)
    _, _, jg32, js32 = run_both(cell32, req, seed=9)
    jg16, _ = jax_upper_phy.UpperPhy(to_jax(cell16)).process_dl_slot(to_jax(req), to_jax(data))
    assert g16.dtype == np.complex64
    scale = np.abs(jg32).max()
    np.testing.assert_allclose(g16, jg32, atol=scale * 2 ** -8)
    np.testing.assert_allclose(g16, jg16, atol=scale * 2 ** -8)
    assert np.sqrt(np.mean((s16 - js32) ** 2) / np.mean(js32 ** 2)) < 5e-3


def test_batched_dl_slot_matches_per_slot_calls():
    """Three slots of one structure (other UEs, rv and DCI) in one batched
    `dl_slot_on_device` call give the per-slot grids and samples."""
    cell = dataclasses.replace(CELL4, nof_rb=24, dft_size=512)
    reqs = []
    for i, (rnti, rv) in enumerate([(0x10, 0), (0x2222, 1), (0x31, 3)]):
        dci = np.random.default_rng(i).integers(0, 2, 40).astype(np.uint8)
        reqs.append(DlTtiRequest(
            slot=4,
            pdsch=(pdsch(rnti=rnti, rv=rv, rb_start=0, rb_size=24, start_symbol=2,
                         dmrs_symbols=(2,)),),
            pdcch=(with_payload(PdcchPdu(rnti=rnti, nof_dci_bits=40, aggregation_level=4,
                                         cce_index=0, start_symbol=1, n_id=i, n_rnti=rnti,
                                         coreset_nof_rb=24), dci),),
            ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=i, half_radio_frame=False),),
            csi_rs=(CsiRsPdu(nof_rb=24, symbol=13, subcarrier_offset=3, scrambling_id=i),)))
    program = dl_slot.get_dl_slot_program(reqs[0], cell, "cpu")
    for req in reqs:
        assert dl_slot.get_dl_slot_program(req, cell, "cpu") is program
    grid, samples = dl_slot_on_device(program, 4, reqs,
                                      [tx_data(req, cell, i) for i, req in enumerate(reqs)])
    assert grid.shape == (3, 4, 14, 24 * 12, 2) and grid.dtype == torch.float32
    phy = UpperPhy(cell, device="cpu")
    for i, req in enumerate(reqs):
        g1, s1 = phy.process_dl_slot(req, tx_data(req, cell, i), fetch=False)
        np.testing.assert_array_equal(grid[i].numpy(), g1.numpy())
        np.testing.assert_array_equal(samples[i].numpy(), s1.numpy())
        run_both(cell, req, seed=i)


def _same_array(got: np.ndarray, want) -> None:
    want = np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def test_host_values_equal_jax_at_the_north_star_width():
    """`build_dl_slot_inputs` + `value_args` on the benchmark's DL pool (273
    PRB, 4 ports) equal the JAX package's values array for array: value,
    dtype and shape.  JAX hands its program the PDCCH symbols and DM-RS
    concatenated in its block order, so those are compared so arranged."""
    from srsran_projectvtlmo_tpu.phy import dl_slot as jax_dl_slot
    from srsran_projectvtlmo_tpu_torch.models.sch_tx import sch_k0_prime
    from tests.test_torch_tracing import dl_cell

    config, pool = dl_cell(seed=4800000101)
    cell = UpperPhy(CellConfig(**{k: v for k, v in config["cell"].items()
                                  if k in CellConfig.__dataclass_fields__}), device="cpu").cfg
    assert cell.nof_rb == 273 and cell.nof_tx_ports == 4
    for entry in pool:
        req, data = entry.args
        program = dl_slot.get_dl_slot_program(req, cell, "cpu")
        (tb, pdsch_dmrs, pdcch_syms, pdcch_dmrs, ssb, csi, scr, k0p, ws, pw, sw) = \
            program.value_args(req, dl_slot.build_dl_slot_inputs(program, req, data, req.slot))
        jreq = to_jax_request(req)
        jprog = jax_dl_slot.get_dl_slot_program(jreq, to_jax(cell))
        (jtb, jdmrs, jpdcch, jpdcch_dmrs, jssb, jcsi, jscr, jk0p, jws, jpw, jsw) = \
            jprog._value_args(req.slot, *jax_dl_slot.build_dl_slot_inputs(
                jprog, jreq, to_jax(data), req.slot), pdsch_pdus=tuple(jreq.pdsch),
                pdcch_pdus=tuple(jreq.pdcch), ssb_pdus=tuple(jreq.ssb))
        assert len(pdcch_syms) == len(jpdcch) == 1 and len(ssb) == 1 and not jpdcch_dmrs
        for got, want in zip(tb + pdsch_dmrs + ssb + csi + ws + pw + sw,
                             jtb + jdmrs + jssb + jcsi + jws + jpw + jsw, strict=True):
            _same_array(got, want)
        for i, order in enumerate(layout["order"] for layout in jprog.pdcch_layout):
            _same_array(np.concatenate([pdcch_syms[i], pdcch_dmrs[i]])[order], jpdcch[i])
        for planes, jplanes in zip(scr, jscr, strict=True):
            for got, want in zip(planes, jplanes, strict=True):
                _same_array(got, want)
        # JAX takes the rv one-hot, the port that rv's circular-buffer start.
        assert k0p == tuple(sch_k0_prime(cfg, int(np.argmax(oh)))
                            for cfg, oh in zip(program.pdsch_cfgs, jk0p, strict=True))


def test_fetch_false_single_port_and_validation():
    """fetch=False hands back the device tensors; a one-port cell's grid and
    samples are squeezed; an invalid request fails as in JAX."""
    req = DlTtiRequest(slot=7, pdsch=(_ue(0x4601),),
                       ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=0,
                                   half_radio_frame=False),))
    grid, samples, _, _ = run_both(CELL1, req, seed=3)
    assert grid.shape == (14, 24 * 12) and samples.ndim == 2
    data = tx_data(req, CELL1, 3)
    g, s = UpperPhy(CELL1, device="cpu").process_dl_slot(req, data, fetch=False)
    assert isinstance(g, torch.Tensor) and g.shape == (1, 14, 24 * 12, 2)
    np.testing.assert_array_equal(s[0].numpy(), samples)
    bad = DlTtiRequest(slot=7, pdsch=(_ue(0x4601), _ue(0x4602)))
    with pytest.raises(FapiValidationError) as terr:
        UpperPhy(CELL1, device="cpu").process_dl_slot(bad, data)
    with pytest.raises(jax_upper_phy.FapiValidationError) as jerr:
        jax_upper_phy.UpperPhy(to_jax(CELL1)).process_dl_slot(to_jax(bad), to_jax(data))
    assert str(terr.value) == str(jerr.value)


def test_cpu_run_stacked_is_eager_and_never_captures():
    """On a CPU device every `run_stacked` call, the first and the later ones
    of both OFDM phases, is `_assemble` itself: no replay key is kept, no
    graph is captured or replayed."""
    cell = dataclasses.replace(CELL4, nof_rb=24, dft_size=512)
    req = DlTtiRequest(
        slot=4, pdsch=(pdsch(rnti=0x77, rv=2, rb_start=0, rb_size=24, start_symbol=2,
                             dmrs_symbols=(2,)),),
        pdcch=(with_payload(PdcchPdu(rnti=0x77, nof_dci_bits=40, aggregation_level=4,
                                     cce_index=0, start_symbol=1, n_id=5, n_rnti=0x77,
                                     coreset_nof_rb=24),
                            np.random.default_rng(9).integers(0, 2, 40).astype(np.uint8)),),
        ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=3, half_radio_frame=False),),
        csi_rs=(CsiRsPdu(nof_rb=24, symbol=13, subcarrier_offset=3, scrambling_id=5),))
    program = dl_slot.DlSlotProgram(dl_slot.plan_key_for(req, cell), cell, "cpu")
    values = dl_slot.build_dl_slot_inputs(program, req, tx_data(req, cell, 9), req.slot)
    stacked = program.stack_values([program.value_args(req, values)] * 2)
    for slot in (4, 4, 5, 5, 5):
        with tracing.entry("test.dl_slot") as rec:
            grid, samples = program.run_stacked(slot, stacked)
        assert "dl_graph_replays" not in rec and "dl_graph_captures" not in rec
        want_grid, want_samples = program._assemble(slot % 2, *stacked)
        assert torch.equal(grid, want_grid) and torch.equal(samples, want_samples)
    assert program._replays is None


def test_graph_copy_in_finds_the_uploads_flat_tensor():
    """`_tiled_base` gives the one flat tensor per dtype that `upload_many`
    uploads, when its views are given whole and in order, and None
    otherwise (the graph then copies array by array)."""
    arrays = [np.arange(6, dtype=np.uint8).reshape(2, 3), np.ones((2, 2), np.float32),
              np.arange(4, dtype=np.uint8) + 6]
    up = upload_many(arrays, torch.device("cpu"))
    base = dl_slot._tiled_base([up[0], up[2]])
    assert base is not None and torch.equal(base, torch.arange(10, dtype=torch.uint8))
    assert dl_slot._tiled_base([up[1]]).shape == (4,)
    assert dl_slot._tiled_base([up[2], up[0]]) is None
    assert dl_slot._tiled_base([up[0]]) is None
    assert dl_slot._tiled_base([torch.zeros(3)]) is None


# ------------------------------------------------------------ the DL fetch --

def _fetch_request(cell: CellConfig, slot: int, seed: int) -> DlTtiRequest:
    """A slot of every channel on a 24-PRB cell: 2-layer QAM16 PDSCH on 4
    ports (1 layer, no precoder, on 1 port), PDCCH, SSB and CSI-RS, its UE
    and DCI from the seed."""
    rng = np.random.default_rng(seed)
    rnti = int(rng.integers(1, 65520))
    ports = cell.nof_tx_ports
    ue = pdsch(rnti=rnti, rb_start=0, rb_size=24, start_symbol=2, dmrs_symbols=(2,),
               n_id=int(rng.integers(0, 1008)),
               **({} if ports == 4 else dict(nof_layers=1, precoding=None)))
    return DlTtiRequest(
        slot=slot, pdsch=(ue,),
        pdcch=(with_payload(PdcchPdu(rnti=rnti, nof_dci_bits=40, aggregation_level=4,
                                     cce_index=0, start_symbol=1, n_id=seed, n_rnti=rnti,
                                     coreset_nof_rb=24),
                            rng.integers(0, 2, 40).astype(np.uint8)),),
        ssb=(SsbPdu(phys_cell_id=1, ssb_block_index=0, sfn=seed, half_radio_frame=False),),
        csi_rs=(CsiRsPdu(nof_rb=24, symbol=13, subcarrier_offset=3, scrambling_id=seed),))


def _fetch_before_staging(grid_pair: torch.Tensor, samples: torch.Tensor):
    """The DL fetch as `UpperPhy.process_dl_slot` wrote it before the
    pinned staging: the grid through float32 numpy and three complex64
    temporaries, the samples as the tensor's values."""
    g = grid_pair.float().numpy()
    return (g[..., 0].astype(np.complex64) + 1j * g[..., 1].astype(np.complex64),
            samples.numpy())


FETCH_CELLS = {
    "4port_bf16": dataclasses.replace(CELL4, nof_rb=24, dft_size=512, grid_bf16=True),
    "4port_float32": dataclasses.replace(CELL4, nof_rb=24, dft_size=512),
    "1port": CELL1,
}


@pytest.mark.parametrize("name", FETCH_CELLS)
def test_fetch_dl_outputs_equals_the_fetch_before_staging(name):
    """`tables.fetch_dl_outputs` and `process_dl_slot(fetch=True)` give the
    arrays of the old fetch expression (values, dtype, shape, C order; a
    one-port cell squeezed); the arrays are the caller's own: a later call,
    or zeroing the fetched tensors, leaves them as they were; the entry
    counts the same `d2h_bytes` and, on the CPU, `dl_pinned_fetches` 0."""
    cell = FETCH_CELLS[name]
    phy = UpperPhy(cell, device="cpu")
    req = _fetch_request(cell, 4, 1)
    data = tx_data(req, cell, 1)
    grid_pair, samples = phy.process_dl_slot(req, data, fetch=False)
    want = [w.copy() for w in _fetch_before_staging(grid_pair, samples)]
    nbytes = sum(t.numel() * t.element_size() for t in (grid_pair, samples))
    with tracing.entry("test.dl_fetch") as rec:
        got = tables.fetch_dl_outputs(grid_pair, samples, complex_grid=True)
    assert rec == {"entry": "test.dl_fetch", "d2h_bytes": nbytes, "dl_pinned_fetches": 0}
    entry_got = phy.process_dl_slot(req, data)
    rec = tracing.last_calls(1)[0]
    assert rec["d2h_bytes"] == nbytes and rec["dl_pinned_fetches"] == 0
    squeezed = [w[0] for w in want] if cell.nof_tx_ports == 1 else want
    for outs, wants in ((got, want), (entry_got, squeezed)):
        for a, w in zip(outs, wants):
            assert a.dtype == w.dtype and a.shape == w.shape and a.flags.c_contiguous
            np.testing.assert_array_equal(a, w)
    kept = [a.copy() for a in entry_got]
    other = _fetch_request(cell, 5, 2)
    later = phy.process_dl_slot(other, tx_data(other, cell, 2))
    assert not np.array_equal(later[0], entry_got[0])
    for a, k in zip(entry_got, kept):
        np.testing.assert_array_equal(a, k)
    grid_pair.zero_(), samples.zero_()
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "per_cell"])
def test_multi_cell_fetch_returns_float32_pairs_of_the_cells(batched):
    """`MultiCellUpperPhy.process_dl_slot(fetch=True)` on two bf16 cells, one
    batched call or the per-cell fallback: float32 real pairs equal to each
    cell's own `process_dl_slot(fetch=False)` values."""
    from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy

    cell = FETCH_CELLS["4port_bf16"]
    reqs = [_fetch_request(cell, 4, seed) for seed in (3, 4)]
    if not batched:
        reqs[1] = dataclasses.replace(reqs[1], csi_rs=())
    datas = [tx_data(r, cell, seed) for r, seed in zip(reqs, (3, 4))]
    grids, samples = MultiCellUpperPhy(cell, 2, device="cpu").process_dl_slot(
        reqs, datas, fetch=True)
    assert grids.dtype == samples.dtype == np.float32
    assert grids.shape == (2, 4, 14, 24 * 12, 2)
    phy = UpperPhy(cell, device="cpu")
    for c in range(2):
        g, s = phy.process_dl_slot(reqs[c], datas[c], fetch=False)
        np.testing.assert_array_equal(grids[c], g.float().numpy())
        np.testing.assert_array_equal(samples[c], s.numpy())
