"""PyTorch port, host-side copies: the port carries its own copies of the JAX
package's host modules (`ran/ldpc_params`, `ran/modulation`, `ran/sch`,
`ran/ulsch_info`, `ops/prg`, `ops/dmrs`, `ops/ulsch_demux`, `ops/polar/code`)
and of the base-graph and polar data files, so that it imports nothing of the
JAX package.  Each copy is held equal to its original here, value by value.

`port_mod` and `port_kw` translate the JAX package's `Modulation` into the
port's own enum, for tests that hand one configuration to both packages.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from srsran_projectvtlmo_tpu.ops import dmrs as jax_dmrs
from srsran_projectvtlmo_tpu.ops import prg as jax_prg
from srsran_projectvtlmo_tpu.ops import ulsch_demux as jax_demux
from srsran_projectvtlmo_tpu.ops.polar import code as jax_polar_code
from srsran_projectvtlmo_tpu.ran import ldpc_params as jax_params
from srsran_projectvtlmo_tpu.ran import modulation as jax_modulation
from srsran_projectvtlmo_tpu.ran import sch as jax_sch
from srsran_projectvtlmo_tpu.ran import ulsch_info as jax_ulsch_info

from srsran_projectvtlmo_tpu_torch.ops import dmrs, prg, ulsch_demux
from srsran_projectvtlmo_tpu_torch.ops.polar import code as polar_code
from srsran_projectvtlmo_tpu_torch.ran import ldpc_params, modulation, sch, ulsch_info

REPO = Path(__file__).resolve().parent.parent


def port_mod(mod):
    """The port's `Modulation` member with the value of `mod` (either enum)."""
    return modulation.Modulation(mod.value)


def port_kw(kw: dict) -> dict:
    """Configuration keywords with `modulation` as the port's enum."""
    return {**kw, "modulation": port_mod(kw["modulation"])} if "modulation" in kw else kw


def test_ldpc_params_equal():
    for name in ("ALL_LIFTING_SIZES", "MAX_LIFTING_SIZE", "MAX_MESSAGE_SIZE",
                 "MAX_CODEBLOCK_SIZE", "FILLER_BIT"):
        assert getattr(ldpc_params, name) == getattr(jax_params, name), name
    assert [(m.name, int(m)) for m in ldpc_params.BaseGraph] == \
        [(m.name, int(m)) for m in jax_params.BaseGraph]
    for bg in ldpc_params.BaseGraph:
        assert ldpc_params.bg_params(bg) == jax_params.bg_params(jax_params.BaseGraph(int(bg)))
    for z in ldpc_params.ALL_LIFTING_SIZES:
        assert ldpc_params.lifting_index(z) == jax_params.lifting_index(z), z
        assert ldpc_params.lifting_size_position(z) == jax_params.lifting_size_position(z), z
    for z in (17, 19, 400, 1):
        with pytest.raises(ValueError):
            ldpc_params.lifting_index(z)
        with pytest.raises(ValueError):
            jax_params.lifting_index(z)
    for kb in (6, 8, 9, 10, 22):
        for k_prime in range(1, kb * 384 + 1, 37):
            assert ldpc_params.min_lifting_size(kb, k_prime) == \
                jax_params.min_lifting_size(kb, k_prime), (kb, k_prime)


def test_modulation_equal():
    assert [(m.name, m.value) for m in modulation.Modulation] == \
        [(m.name, m.value) for m in jax_modulation.Modulation]
    for m in jax_modulation.Modulation:
        assert modulation.bits_per_symbol(port_mod(m)) == jax_modulation.bits_per_symbol(m)


@pytest.mark.parametrize("rate", [0.08, 0.25, 0.5, 0.67, 948 / 1024])
def test_sch_derivations_equal(rate):
    """tbs_calculator over RE counts, layers, modulations and TB scaling;
    base-graph choice and segmentation of each TBS."""
    for nof_re in (12, 100, 1000, 3276 * 12, 3276 * 13):
        for qm in (1, 2, 4, 6, 8):
            for layers in (1, 2, 4):
                for scaling in (0, 1, 2):
                    kw = dict(nof_re=nof_re, target_code_rate=rate, modulation_bits=qm,
                              nof_layers=layers, tb_scaling_field=scaling)
                    tbs = sch.tbs_calculator(**kw)
                    assert tbs == jax_sch.tbs_calculator(**kw), kw
                    assert sch.choose_base_graph(tbs, rate) == \
                        jax_sch.choose_base_graph(tbs, rate), kw
                    a, b = sch.sch_segmentation_info(tbs, rate), \
                        jax_sch.sch_segmentation_info(tbs, rate)
                    assert dataclasses.asdict(a) == dataclasses.asdict(b), kw
                    assert a.nof_info_bits == b.nof_info_bits, kw
    assert sch.TBS_TABLE == jax_sch.TBS_TABLE


@pytest.mark.parametrize("c_init", [0, 1, 0x1234, (1 << 31) - 1])
def test_prg_sequences_equal(c_init):
    for n in (1, 31, 32, 1000, 70000):
        np.testing.assert_array_equal(prg.gold_sequence_packed(c_init, n),
                                      jax_prg.gold_sequence_packed(c_init, n))
        np.testing.assert_array_equal(prg.gold_sequence_bits(c_init, n),
                                      jax_prg.gold_sequence_bits(c_init, n))
        np.testing.assert_array_equal(prg.gold_sequence_signs(c_init, n),
                                      jax_prg.gold_sequence_signs(c_init, n))
    assert prg.NC == jax_prg.NC


@pytest.mark.parametrize("nof_rb,prb_start,n_scid", [(1, 0, 0), (24, 3, 1), (273, 0, 0)])
def test_dmrs_sequences_equal(nof_rb, prb_start, n_scid):
    for slot, symbol, n_id in ((0, 2, 0), (7, 11, 1007), (19, 3, 500)):
        assert dmrs.dmrs_cinit(slot, symbol, n_id, n_scid) == \
            jax_dmrs.dmrs_cinit(slot, symbol, n_id, n_scid)
        for fn in ("dmrs_type1_sequence", "dmrs_type2_sequence"):
            np.testing.assert_array_equal(
                getattr(dmrs, fn)(slot, symbol, n_id, nof_rb, prb_start=prb_start, n_scid=n_scid),
                getattr(jax_dmrs, fn)(slot, symbol, n_id, nof_rb, prb_start=prb_start,
                                      n_scid=n_scid), err_msg=fn)
    for delta in (0, 1, 2):
        np.testing.assert_array_equal(dmrs.dmrs_type1_subcarriers(nof_rb, delta),
                                      jax_dmrs.dmrs_type1_subcarriers(nof_rb, delta))
        np.testing.assert_array_equal(dmrs.dmrs_type2_subcarriers(nof_rb, delta),
                                      jax_dmrs.dmrs_type2_subcarriers(nof_rb, delta))


_DEMUX = [
    dict(nof_prb=273, start_symbol_index=0, nof_symbols=14, dmrs_symbols=(2, 11), qm=8,
         nof_layers=2),
    dict(nof_prb=24, start_symbol_index=0, nof_symbols=14, dmrs_symbols=(2,), qm=6,
         nof_layers=1, nof_harq_ack_bits=2, nof_enc_harq_ack_bits=24, nof_harq_ack_rvd=24),
    dict(nof_prb=6, start_symbol_index=1, nof_symbols=12, dmrs_symbols=(3, 9), qm=4,
         nof_layers=4, nof_harq_ack_bits=5, nof_enc_harq_ack_bits=64, nof_csi_part1_bits=7,
         nof_enc_csi_part1_bits=96, nof_csi_part2_bits=1, nof_enc_csi_part2_bits=48),
    dict(nof_prb=4, start_symbol_index=0, nof_symbols=14, dmrs_symbols=(2, 7, 11), qm=2,
         nof_layers=1, nof_harq_ack_bits=1, nof_enc_harq_ack_bits=8, nof_harq_ack_rvd=8,
         nof_csi_part1_bits=2, nof_enc_csi_part1_bits=20),
]


@pytest.mark.parametrize("kw", _DEMUX)
def test_ulsch_demux_plan_equal(kw):
    a, b = ulsch_demux.build_ulsch_demux_plan(**kw), jax_demux.build_ulsch_demux_plan(**kw)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
    g = kw["nof_prb"] * 12 * (kw["nof_symbols"] - len(kw["dmrs_symbols"])) * kw["qm"] * \
        kw["nof_layers"]
    scr = jax_prg.gold_sequence_bits(0x5A5A, g)
    for x, y in zip(ulsch_demux.scramble_codeword_with_placeholders(None, scr, a),
                    jax_demux.scramble_codeword_with_placeholders(None, scr, b)):
        np.testing.assert_array_equal(x, y)
    for name in ("ack", "csi1", "csi2"):
        idx, payload = a.field_bit_idx(name), a.field_payload(name)
        for x, y in zip(ulsch_demux.placeholder_masks(payload, len(idx), kw["qm"]),
                        jax_demux.placeholder_masks(payload, len(idx), kw["qm"])):
            np.testing.assert_array_equal(x, y)
        if len(idx):
            np.testing.assert_array_equal(
                ulsch_demux.placeholder_fix_signs(idx, payload, kw["qm"], scr),
                jax_demux.placeholder_fix_signs(idx, payload, kw["qm"], scr))


def test_graph_data_file_equal():
    """The port reads its own copy of the base-graph tables."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc import graphs

    ours = REPO / "srsran_projectvtlmo_tpu_torch" / "data" / "ldpc_base_graphs.npz"
    assert graphs._DATA == ours
    _data_files_equal(ours, REPO / "srsran_projectvtlmo_tpu" / "data" / "ldpc_base_graphs.npz")


def _data_files_equal(ours: Path, theirs: Path):
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("nof_rb,dmrs_symbols,layers,qm,rate", [
    (12, (2, 11), 2, 4, 0.5), (273, (2, 11), 2, 8, 948 / 1024), (5, (2,), 1, 2, 0.2),
    (24, (3, 7, 11), 4, 6, 0.6)])
def test_ulsch_info_equal(nof_rb, dmrs_symbols, layers, qm, rate):
    """UCI budgets over payload sizes (none, short block, polar, 2-codeblock)
    and beta offsets, with the SCH size they leave."""
    nof_re = nof_rb * 12 * (14 - len(dmrs_symbols))
    tbs = sch.tbs_calculator(nof_re=nof_re, target_code_rate=rate, modulation_bits=qm,
                             nof_layers=layers)
    seg = sch.sch_segmentation_info(tbs, rate)
    for ack, csi1, csi2 in ((0, 0, 0), (1, 0, 0), (2, 20, 48), (40, 6, 0), (11, 0, 9),
                            (0, 400, 13), (3, 12, 600)):
        for betas in ((1.0, 2.0, 2.0, 2.0), (0.5, 6.25, 1.25, 3.5)):
            kw = dict(nof_rb=nof_rb, start_symbol_index=0, nof_symbols=14,
                      dmrs_symbols=dmrs_symbols, nof_layers=layers, qm=qm,
                      target_code_rate=rate, tbs=tbs,
                      sum_nof_cb_size=seg.nof_cb * seg.nof_bits_per_cb,
                      nof_harq_ack_bits=ack, nof_csi_part1_bits=csi1, nof_csi_part2_bits=csi2,
                      alpha_scaling=betas[0], beta_offset_harq_ack=betas[1],
                      beta_offset_csi_part1=betas[2], beta_offset_csi_part2=betas[3])
            assert dataclasses.asdict(ulsch_info.get_ulsch_information(**kw)) == \
                dataclasses.asdict(jax_ulsch_info.get_ulsch_information(**kw)), kw


def test_polar_code_sets_equal():
    """N, the information, frozen and parity-check sets over a sweep of
    (K, E, n_max, ibil): downlink and uplink, puncturing, shortening and
    repetition, with and without parity-check bits."""
    for n in range(5, 11):
        np.testing.assert_array_equal(polar_code.blk_interleaver(n),
                                      jax_polar_code.blk_interleaver(n))
    np.testing.assert_array_equal(polar_code.SUBBLOCK_PATTERN, jax_polar_code.SUBBLOCK_PATTERN)
    cases = [(k, e, 10, True) for k in (18, 20, 25, 31, 40, 64, 100, 211, 500, 1000)
             for e in (k + 30, 2 * k + 7, 4 * k, 8 * k + 3, 2000) if k + 3 < e <= 8192]
    cases += [(k, e, 9, ibil) for k in (36, 56, 100, 164) for e in (108, 216, 432, 864)
              for ibil in (False, True) if k < e]
    for k, e, n_max, ibil in cases:
        a = polar_code.PolarCode(K=k, E=e, n_max=n_max, ibil=ibil)
        b = jax_polar_code.PolarCode(K=k, E=e, n_max=n_max, ibil=ibil)
        assert (a.n, a.N, a.n_pc, a.n_wm_pc) == (b.n, b.N, b.n_pc, b.n_wm_pc), (k, e)
        for name in ("k_set", "frozen_mask", "pc_set"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_polar_data_file_equal():
    """The port reads its own copy of the polar mother-code tables."""
    ours = REPO / "srsran_projectvtlmo_tpu_torch" / "data" / "polar_tables.npz"
    assert polar_code._DATA == ours
    _data_files_equal(ours, REPO / "srsran_projectvtlmo_tpu" / "data" / "polar_tables.npz")
