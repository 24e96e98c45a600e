"""PyTorch port, host-side copies: the port carries its own copies of the JAX
package's host modules (`ran/ldpc_params`, `ran/modulation`, `ran/sch`,
`ran/ulsch_info`, `ops/prg`, `ops/dmrs`, `ops/ulsch_demux`, `ops/polar/code`;
for the uplink FAPI entry point `fapi/pdus`, `fapi/validators`,
`ran/prach_preamble`, `ran/prach_cyclic_shifts`, `ran/prach_config`,
`ops/low_papr`, `phy/error_handler`; for the downlink slot
`ran/re_pattern`, `ran/pdcch_mapping`, `ops/csi_rs`; for the scaling layer
`parallel/sample_shard._demod_plan`) and of the base-graph,
polar, low-PAPR and PRACH data files, so that it imports nothing of the JAX
package.  Each copy is held equal to its original here, value by value, and
the uplink and downlink copies also code by code (their docstrings aside).

`port_mod` and `port_kw` translate the JAX package's `Modulation` into the
port's own enum, for tests that hand one configuration to both packages.
"""

import ast
import dataclasses
import json
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


def port_rx_kw(kw: dict) -> dict:
    """`port_kw` of a PUSCH receiver's keywords with the JAX package's noise
    estimate (`PuschRxConfig.unbiased_noise` False), so that the port's
    receiver is held to the JAX one output for output."""
    return {**port_kw(kw), "unbiased_noise": False}


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


_UL_COPIES = ("fapi/__init__.py", "fapi/pdus.py", "fapi/validators.py", "ran/prach_preamble.py",
              "ran/prach_cyclic_shifts.py", "ran/prach_config.py", "ops/low_papr.py",
              "phy/error_handler.py")


def _code(path: Path) -> str:
    """The module's syntax tree without its docstrings."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", _UL_COPIES)
def test_uplink_host_copy_code_equal(rel):
    assert _code(REPO / "srsran_projectvtlmo_tpu_torch" / rel) == \
        _code(REPO / "srsran_projectvtlmo_tpu" / rel), rel


@pytest.mark.parametrize("name", ["low_papr_tables.npz", "prach_tables.npz",
                                  "prach_thresholds.npz"])
def test_uplink_data_files_equal(name):
    """The port reads its own copies of the low-PAPR and PRACH tables."""
    from srsran_projectvtlmo_tpu_torch.ops import low_papr, prach

    ours = REPO / "srsran_projectvtlmo_tpu_torch" / "data" / name
    assert ours in (low_papr._DATA, prach._DATA, prach._THRESH)
    _data_files_equal(ours, REPO / "srsran_projectvtlmo_tpu" / "data" / name)


def test_prach_config_tables_equal():
    from srsran_projectvtlmo_tpu.ran import prach_config as jax_prach_config
    from srsran_projectvtlmo_tpu_torch.ran import prach_config

    ours = REPO / "srsran_projectvtlmo_tpu_torch" / "data" / "prach_config_tables.json"
    assert prach_config._DATA == ours
    theirs = REPO / "srsran_projectvtlmo_tpu" / "data" / "prach_config_tables.json"
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    for duplex in ("fr1_paired", "fr1_unpaired"):
        for index in range(256):
            assert dataclasses.asdict(prach_config.prach_configuration(duplex, index)) == \
                dataclasses.asdict(jax_prach_config.prach_configuration(duplex, index))


def test_prach_preamble_and_cyclic_shifts_equal():
    from srsran_projectvtlmo_tpu.ran import prach_cyclic_shifts as jax_shifts
    from srsran_projectvtlmo_tpu.ran import prach_preamble as jax_preamble
    from srsran_projectvtlmo_tpu_torch.ran import prach_cyclic_shifts, prach_preamble

    for fmt in prach_preamble.LONG_FORMATS + prach_preamble.SHORT_FORMATS:
        for mu in (0, 1, 2, 3):
            a, b = prach_preamble.preamble_info(fmt, mu), jax_preamble.preamble_info(fmt, mu)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (fmt, mu)
            assert a.cp_prach == b.cp_prach, (fmt, mu)
    for scs in ("1.25kHz", "5kHz", "15kHz", "30kHz"):
        for restricted in prach_cyclic_shifts.RestrictedSetConfig:
            theirs = jax_shifts.RestrictedSetConfig(restricted.value)
            for zcz in range(16):
                assert prach_cyclic_shifts.prach_cyclic_shifts_get(scs, restricted, zcz) == \
                    jax_shifts.prach_cyclic_shifts_get(scs, theirs, zcz), (scs, restricted, zcz)


def test_ul_tti_validation_equal():
    """The same requests give the same reports, valid or not."""
    from srsran_projectvtlmo_tpu.fapi import pdus as jax_pdus
    from srsran_projectvtlmo_tpu.fapi import validators as jax_validators
    from srsran_projectvtlmo_tpu_torch.fapi import pdus, validators

    def request(mod, lib):
        pusch = lib.PuschPdu(rnti=0x10, rb_start=0, rb_size=8, modulation=mod.QAM16,
                             target_code_rate=0.5)
        return [
            lib.UlTtiRequest(slot=0, pusch=(pusch,)),
            lib.UlTtiRequest(slot=1, pusch=(dataclasses.replace(
                pusch, nof_csi_part1_bits=2, part2_size_map=(4, 6)), dataclasses.replace(
                pusch, hop_symbol=7, dmrs_symbols=(2, 3), rv=1))),
            lib.UlTtiRequest(slot=2, pucch=(lib.PucchPdu(format=3, rnti=1, prb_start=0,
                                                         nof_prb=1, start_symbol=0,
                                                         nof_symbols=14),
                                            lib.PucchPdu(format=2, rnti=0, prb_start=300,
                                                         nof_prb=20, start_symbol=13,
                                                         nof_symbols=2, nof_uci_bits=2)),
                             prach=(lib.PrachPdu(root_sequence_index=900, restricted_set=1),),
                             srs=(lib.SrsPdu(rnti=1, nof_rb=2, comb_size=3, cyclic_shift=9),)),
        ]

    for a, b in zip(request(modulation.Modulation, pdus),
                    request(jax_modulation.Modulation, jax_pdus)):
        ra, rb = validators.validate_ul_tti_request(a), jax_validators.validate_ul_tti_request(b)
        assert ra.ok == rb.ok
        assert [str(e) for e in ra.errors] == [str(e) for e in rb.errors]



_DL_COPIES = ("ran/re_pattern.py", "ran/pdcch_mapping.py", "ops/csi_rs.py")


@pytest.mark.parametrize("rel", _DL_COPIES)
def test_downlink_host_copy_code_equal(rel):
    assert _code(REPO / "srsran_projectvtlmo_tpu_torch" / rel) == \
        _code(REPO / "srsran_projectvtlmo_tpu" / rel), rel


def test_re_pattern_values_equal():
    """Masks and inclusion counts over strided, partial and CSI-RS patterns."""
    from srsran_projectvtlmo_tpu.ops import csi_rs as jax_csi_rs
    from srsran_projectvtlmo_tpu.ran import re_pattern as jax_re_pattern
    from srsran_projectvtlmo_tpu_torch.ops import csi_rs
    from srsran_projectvtlmo_tpu_torch.ran import re_pattern

    rng = np.random.default_rng(3)
    masks = [tuple(bool(b) for b in rng.integers(0, 2, 12)) for _ in range(2)]
    kws = [dict(rb_begin=2, rb_end=20, re_mask=masks[0], symbols=(3, 7)),
           dict(rb_begin=10, rb_end=30, rb_stride=2, re_mask=masks[1], symbols=(7, 9))]
    ours = tuple(re_pattern.RePattern(**kw) for kw in kws)
    theirs = tuple(jax_re_pattern.RePattern(**kw) for kw in kws)
    for rb_start, nof_rb, syms in ((4, 18, [2, 3, 7, 9, 11]), (0, 40, list(range(14)))):
        np.testing.assert_array_equal(re_pattern.reserved_mask_window(ours, rb_start, nof_rb, syms),
                                      jax_re_pattern.reserved_mask_window(theirs, rb_start, nof_rb,
                                                                          syms))
        assert re_pattern.inclusion_count(ours, rb_start, nof_rb, syms) == \
            jax_re_pattern.inclusion_count(theirs, rb_start, nof_rb, syms)
    for row, density in ((1, "three"), (4, "one"), (2, "dot5_odd"), (12, "one")):
        kw = dict(nof_rb=16, prb_start=2, row=row, k_ref=(0, 2, 4, 6)[:csi_rs.ROW_NOF_KREF[row]],
                  symbol=5, density=density)
        assert re_pattern.csi_rs_patterns(csi_rs.CsiRsConfig(**kw)) == tuple(
            re_pattern.RePattern(**dataclasses.asdict(p))
            for p in jax_re_pattern.csi_rs_patterns(jax_csi_rs.CsiRsConfig(**kw)))
    assert dataclasses.asdict(re_pattern.coreset_pattern(0, 24, 1, 2)) == \
        dataclasses.asdict(jax_re_pattern.coreset_pattern(0, 24, 1, 2))


def test_pdcch_mapping_values_equal():
    """CCE-to-REG mapping, interleaved and not, PRBs and RE indices."""
    from srsran_projectvtlmo_tpu.ran import pdcch_mapping as jax_map
    from srsran_projectvtlmo_tpu_torch.ran import pdcch_mapping

    for al in (1, 2, 4, 8):
        for cce in (0, 1, 3):
            assert pdcch_mapping.cce_to_reg_non_interleaved(al, cce) == \
                jax_map.cce_to_reg_non_interleaved(al, cce)
            for n_rb, dur, l, r, shift in ((48, 1, 6, 2, 0), (48, 2, 6, 2, 5), (96, 3, 3, 2, 7),
                                           (24, 1, 2, 6, 1)):
                if (cce + al) * 6 > n_rb * dur:
                    continue
                regs = pdcch_mapping.cce_to_reg_interleaved(n_rb, dur, l, r, shift, al, cce)
                assert regs == jax_map.cce_to_reg_interleaved(n_rb, dur, l, r, shift, al, cce)
                prbs = pdcch_mapping.pdcch_coreset_prbs(regs, dur, 5 + np.arange(n_rb))
                assert prbs == jax_map.pdcch_coreset_prbs(regs, dur, 5 + np.arange(n_rb))
                for a, b in zip(pdcch_mapping.pdcch_re_indices(prbs, dur, 1, 1236),
                                jax_map.pdcch_re_indices(prbs, dur, 1, 1236)):
                    np.testing.assert_array_equal(a, b)
    for bad in ((50, 1, 6, 2, 0), (48, 2, 3, 2, 0)):
        with pytest.raises(ValueError):
            pdcch_mapping.cce_to_reg_interleaved(*bad, 1, 0)
        with pytest.raises(ValueError):
            jax_map.cce_to_reg_interleaved(*bad, 1, 0)


def _function_code(path: Path, name: str) -> str:
    """One top-level function's syntax tree without its docstring."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    if isinstance(fn.body[0], ast.Expr) and isinstance(fn.body[0].value, ast.Constant):
        fn.body = fn.body[1:]
    return ast.dump(fn)


@pytest.mark.parametrize("args", [(3872, 8, 256, 1, 0, "normal"), (3872, 4, 256, 1, 1, "normal"),
                                  (61440, 4, 4096, 1, 0, "normal"), (3840, 4, 256, 2, 0, "extended"),
                                  (3872, 16, 256, 1, 0, "normal")])
def test_sample_shard_demod_plan_equal(args):
    """`parallel/sample_shard._demod_plan`, the one host function the port
    copies from the JAX module (which imports jax): the same code and the
    same tables, or the same error when the halo exceeds a shard."""
    from srsran_projectvtlmo_tpu.parallel import sample_shard as jax_sample_shard
    from srsran_projectvtlmo_tpu_torch.parallel import sample_shard

    rel = Path("parallel") / "sample_shard.py"
    assert _function_code(REPO / "srsran_projectvtlmo_tpu_torch" / rel, "_demod_plan") == \
        _function_code(REPO / "srsran_projectvtlmo_tpu" / rel, "_demod_plan")
    try:
        want = jax_sample_shard._demod_plan(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            sample_shard._demod_plan(*args)
        return
    got = sample_shard._demod_plan(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


_APP_COPIES = ("ran/mcs.py", "ran/slot.py", "radio/__init__.py", "radio/gateway.py",
               "ofh/__init__.py", "ofh/ecpri.py", "ofh/ethernet.py", "ofh/cplane.py",
               "ofh/uplane.py", "ofh/reception.py", "utils/sanitizer.py", "utils/bits.py",
               "utils/log.py", "phy/rx_symbol_handler.py")


@pytest.mark.parametrize("rel", _APP_COPIES)
def test_app_and_fronthaul_host_copy_code_equal(rel):
    """The host modules of the app, the fronthaul and the host tooling are
    copies, code for code."""
    assert _code(REPO / "srsran_projectvtlmo_tpu_torch" / rel) == \
        _code(REPO / "srsran_projectvtlmo_tpu" / rel), rel
