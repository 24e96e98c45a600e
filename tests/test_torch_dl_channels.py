"""PyTorch port, the downlink channels module by module against the JAX
package on the same numpy-seeded inputs, and against the stored
reference-C++ vectors where they exist: the polar input interleaver,
PSS/SSS/PBCH and the SS/PBCH block, the PDCCH encoder, modulator, DM-RS
and blind decoder, CSI-RS, the dynamic-value SCH chain for rv 0-3 and the
PDSCH transmit slot.

Tolerances and why:
  * interleaver plans, PBCH/PDCCH codewords, SCH codeword bits, decoded DCI
    bits and CRC flags: equal (integer and bit work);
  * PSS/SSS, PBCH/PDCCH symbols and DM-RS, SSB blocks, CSI-RS values: equal
    to JAX (the same numpy code); within 1e-6 of the reference vectors, the
    bound the JAX package's own tests use (1e-7 for the PDSCH DM-RS);
  * SCH symbols from the bit planes: within 1e-6 (the same float32 formula);
  * `build_pdsch_tx_slot`: grid within 1e-6; samples within 1e-5 relative
    RMS (the inverse FFT summed in another order).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models import pdsch_tx as jax_pdsch_tx
from srsran_projectvtlmo_tpu.models import sch_tx as jax_sch_tx
from srsran_projectvtlmo_tpu.ops import csi_rs as jax_csi_rs
from srsran_projectvtlmo_tpu.ops import prg as jax_prg
from srsran_projectvtlmo_tpu.ops.polar import interleave as jax_interleave
from srsran_projectvtlmo_tpu.phy import pbch as jax_pbch
from srsran_projectvtlmo_tpu.phy import pdcch as jax_pdcch
from srsran_projectvtlmo_tpu.ran.modulation import Modulation, bits_per_symbol

from srsran_projectvtlmo_tpu_torch.fapi.pdus import DlTtiRequest, PdschPdu
from srsran_projectvtlmo_tpu_torch.models import pdsch_tx, sch_tx
from srsran_projectvtlmo_tpu_torch.ops import csi_rs, gf2
from srsran_projectvtlmo_tpu_torch.ops.polar import interleave
from srsran_projectvtlmo_tpu_torch.phy import dl_slot, pbch, pdcch
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig
from tests.test_torch_host_copies import port_kw, port_mod

VECTORS = Path(__file__).parent / "vectors"


def _vectors(name: str) -> dict:
    with np.load(VECTORS / f"{name}_reference.npz") as z:
        return {k: z[k] for k in z.files}


def _pair_c(pair: np.ndarray) -> np.ndarray:
    return pair[..., 0] + 1j * pair[..., 1]


# -------------------------------------------------------------- interleaver --

@pytest.mark.parametrize("k", [1, 25, 56, 64, 100, 163, 164])
def test_interleaver_equal(k):
    np.testing.assert_array_equal(interleave.interleave_plan(k), jax_interleave.interleave_plan(k))
    np.testing.assert_array_equal(interleave.PATTERN, jax_interleave.PATTERN)
    bits = np.random.default_rng(k).integers(0, 2, (3, k)).astype(np.uint8)
    got = interleave.interleave(torch.as_tensor(bits), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_interleave.interleave(jnp.asarray(bits), k)))
    back = interleave.deinterleave(torch.as_tensor(got), k).numpy()
    np.testing.assert_array_equal(back, bits)
    np.testing.assert_array_equal(
        back, np.asarray(jax_interleave.deinterleave(jnp.asarray(got), k)))


# --------------------------------------------------------------- PBCH / SSB --

_PBCH = _vectors("pbch")
_SSB = _vectors("ssb")


def _msgs(lib):
    rng = np.random.default_rng(3)
    return [lib.PbchMessage(sfn=sfn, ssb_idx=idx, half_radio_frame=hrf, n_id=n_id, l_max=l_max,
                            mib_payload=tuple(int(b) for b in rng.integers(0, 2, 24)), k_ssb=k)
            for sfn, idx, hrf, n_id, l_max, k in ((0, 0, False, 1, 8, 0), (123, 2, True, 101, 8, 17),
                                                  (1023, 3, True, 1007, 4, 23),
                                                  (45, 37, False, 500, 64, 5))]


def test_pss_sss_equal():
    for n_id2 in range(3):
        np.testing.assert_array_equal(pbch.pss_sequence(n_id2), jax_pbch.pss_sequence(n_id2))
        for n_id1 in (0, 1, 111, 112, 335):
            np.testing.assert_array_equal(pbch.sss_sequence(n_id1, n_id2),
                                          jax_pbch.sss_sequence(n_id1, n_id2))


@pytest.mark.parametrize("i", range(4))
def test_pbch_and_ssb_equal(i):
    """Payload, scrambling, codeword, symbols, DM-RS and the assembled block,
    over L_max 4/8/64, HRF, SSB index and k_SSB >= 16 (its MSB at G[11])."""
    msg, jmsg = _msgs(pbch)[i], _msgs(jax_pbch)[i]
    np.testing.assert_array_equal(pbch.pbch_payload(msg), jax_pbch.pbch_payload(jmsg))
    np.testing.assert_array_equal(pbch.pbch_encode(msg), jax_pbch.pbch_encode(jmsg))
    np.testing.assert_array_equal(pbch.pbch_modulate(msg), jax_pbch.pbch_modulate(jmsg))
    np.testing.assert_array_equal(pbch.pbch_dmrs(msg), jax_pbch.pbch_dmrs(jmsg))
    np.testing.assert_array_equal(pbch.assemble_ssb(msg, 0.5), jax_pbch.assemble_ssb(jmsg, 0.5))
    if msg.l_max != 64:
        assert pbch.pbch_payload(msg)[pbch.G[11]] == (msg.k_ssb >> 4) & 1


@pytest.mark.parametrize("key", sorted(k[: -len("_mib")] for k in _PBCH if k.endswith("_mib")))
def test_pbch_encoder_matches_reference(key):
    n_id, sfn, ssb_idx, l_max, hrf, k_ssb, _ = (int(v) for v in key[1:].split("_"))
    msg = pbch.PbchMessage(sfn=sfn, ssb_idx=ssb_idx, half_radio_frame=bool(hrf), n_id=n_id,
                           l_max=l_max, mib_payload=tuple(_PBCH[f"{key}_mib"]), k_ssb=k_ssb)
    np.testing.assert_array_equal(pbch.pbch_encode(msg), _PBCH[f"{key}_enc"])


@pytest.mark.parametrize("pci", sorted({int(k[3:].split("_")[0]) for k in _SSB}))
def test_pss_sss_match_reference(pci):
    """The block's PSS and SSS rows against the reference's sequences."""
    block = pbch.assemble_ssb(pbch.PbchMessage(sfn=0, ssb_idx=0, half_radio_frame=False, n_id=pci))
    np.testing.assert_allclose(block[0, 56:183], _pair_c(_SSB[f"pci{pci}_pss"]), atol=1e-6)
    np.testing.assert_allclose(block[2, 56:183], _pair_c(_SSB[f"pci{pci}_sss"]), atol=1e-6)


def test_pbch_polar_roundtrip():
    """The PBCH codeword decodes back through the port's polar decoder to a
    payload whose CRC24C checks (the JAX package's own roundtrip)."""
    from srsran_projectvtlmo_tpu_torch.ops.crc import crc_host
    from srsran_projectvtlmo_tpu_torch.ops.polar import (
        PolarCode, polar_deallocate, polar_decode, rate_matching)

    msg = pbch.PbchMessage(sfn=123, ssb_idx=2, half_radio_frame=False, n_id=101,
                           mib_payload=tuple(np.random.default_rng(0).integers(0, 2, 24)))
    bits = pbch.pbch_encode(msg)
    code = PolarCode(K=pbch.B, E=pbch.E, n_max=9, ibil=False)
    llr = torch.as_tensor(((1 - 2 * bits.astype(np.int32)) * 20).astype(np.int8)[None])
    u = polar_decode(rate_matching.rate_dematch(llr, code), code)
    c = interleave.deinterleave(polar_deallocate(u, code), pbch.B)[0].numpy()
    np.testing.assert_array_equal(crc_host(c[:pbch.A], "CRC24C"), c[pbch.A:])
    np.testing.assert_array_equal(c[:pbch.A], pbch.pbch_scramble_payload(pbch.pbch_payload(msg),
                                                                          msg))


@pytest.mark.parametrize("hrf", [False, True])
@pytest.mark.parametrize("l_max", [4, 8, 64])
def test_pbch_table_encode_equals_chain_and_jax(l_max, hrf):
    """The PBCH encode table against the port's chain and JAX's encoder, the
    symbols and the assembled block against JAX's: every SFN offset v (the
    SFN's 3rd and 2nd LSBs) at several PCIs, random MIB bits, SSB indices
    and k_SSB."""
    rng = np.random.default_rng(7 * l_max + hrf)
    for n_id in (0, 1, 503, 1007):
        for v in range(4):
            kw = dict(sfn=int(rng.integers(0, 128)) * 8 + 2 * v + int(rng.integers(0, 2)),
                      ssb_idx=int(rng.integers(0, l_max)), half_radio_frame=hrf, n_id=n_id,
                      l_max=l_max, mib_payload=tuple(int(b) for b in rng.integers(0, 2, 24)),
                      k_ssb=int(rng.integers(0, 24)))
            msg, jmsg = pbch.PbchMessage(**kw), jax_pbch.PbchMessage(**kw)
            a_prime = pbch.pbch_scramble_payload(pbch.pbch_payload(msg), msg)
            assert 2 * a_prime[pbch.G[7]] + a_prime[pbch.G[8]] == v
            np.testing.assert_array_equal(
                a_prime, jax_pbch.pbch_scramble_payload(jax_pbch.pbch_payload(jmsg), jmsg))
            got = pbch.pbch_encode(msg)
            assert (got.dtype, got.shape) == (np.uint8, (pbch.E,))
            np.testing.assert_array_equal(got, pbch._encode_chain(a_prime))
            np.testing.assert_array_equal(got, jax_pbch.pbch_encode(jmsg))
            block, jblock = pbch.assemble_ssb(msg), jax_pbch.assemble_ssb(jmsg)
            assert (block.dtype, block.shape) == (jblock.dtype, jblock.shape)
            np.testing.assert_array_equal(block, jblock)
            np.testing.assert_array_equal(pbch.pbch_modulate(msg), jax_pbch.pbch_modulate(jmsg))


# -------------------------------------------------------------------- PDCCH --

_PDCCH = _vectors("pdcch")


@pytest.mark.parametrize("key", sorted(k[: -len("_dci")] for k in _PDCCH if k.endswith("_dci")))
def test_pdcch_encoder_matches_reference_and_jax(key):
    k, e, rnti, _ = (int(v) for v in key[1:].split("_"))
    dci = _PDCCH[f"{key}_dci"]
    got = pdcch.pdcch_encode(dci, rnti, e)
    np.testing.assert_array_equal(got, _PDCCH[f"{key}_enc"])
    np.testing.assert_array_equal(got, np.asarray(jax_pdcch.pdcch_encode(dci, rnti, e)))


def _candidate(lib, ndci, al, rnti=0x4601):
    return lib.PdcchCandidateConfig(nof_dci_bits=ndci, aggregation_level=al, rnti=rnti, n_id=42,
                                    n_rnti=0x4601)


@pytest.mark.parametrize("ndci,al", [(20, 1), (39, 2), (60, 4), (124, 8)])
def test_pdcch_modulate_and_blind_decode_as_jax(ndci, al):
    """Symbols equal JAX's; the noisy candidate decodes to the DCI with the
    same bits and CRC flag as the JAX decoder, and a wrong RNTI fails."""
    cfg, jcfg = _candidate(pdcch, ndci, al), _candidate(jax_pdcch, ndci, al)
    rng = np.random.default_rng(ndci)
    dci = rng.integers(0, 2, ndci).astype(np.uint8)
    syms = pdcch.pdcch_modulate(cfg, dci)
    np.testing.assert_array_equal(syms, jax_pdcch.pdcch_modulate(jcfg, dci))
    noisy = syms + 0.05 * (rng.normal(size=syms.shape) + 1j * rng.normal(size=syms.shape))
    pair = np.stack([noisy.real, noisy.imag], -1).astype(np.float32)[None]
    nv = np.full((1, syms.shape[0]), 0.005, np.float32)
    bits, ok = pdcch.pdcch_blind_decode(torch.as_tensor(pair), torch.as_tensor(nv), cfg)
    jbits, jok = jax_pdcch.pdcch_blind_decode(jnp.asarray(pair), jnp.asarray(nv), jcfg)
    assert bool(ok[0]) and bool(np.asarray(jok)[0])
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(bits.numpy()[0], dci)
    _, bad = pdcch.pdcch_blind_decode(torch.as_tensor(pair), torch.as_tensor(nv),
                                      _candidate(pdcch, ndci, al, rnti=0x1111))
    assert not bool(bad[0])


@pytest.mark.parametrize("al", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("ndci", [12, 40, 77])
def test_pdcch_table_encode_equals_chain_and_jax(ndci, al):
    """The PDCCH encode table of (DCI size, E) against the port's chain and
    JAX's encoder, and the scrambled symbols against JAX's, on random DCIs
    and RNTIs, 0 and 65535 among them."""
    e = al * pdcch.RE_PER_CCE * 2
    rng = np.random.default_rng(100 * ndci + al)
    for rnti in [0, 65535] + [int(r) for r in rng.integers(1, 65535, 4)]:
        dci = rng.integers(0, 2, ndci).astype(np.uint8)
        got = pdcch.pdcch_encode(dci, rnti, e)
        assert (got.dtype, got.shape) == (np.uint8, (e,))
        np.testing.assert_array_equal(
            got, pdcch._encode_chain(np.concatenate([dci, pdcch._rnti_bits(rnti)]), ndci, e))
        np.testing.assert_array_equal(got, np.asarray(jax_pdcch.pdcch_encode(dci, rnti, e)))
        cfg, jcfg = _candidate(pdcch, ndci, al, rnti), _candidate(jax_pdcch, ndci, al, rnti)
        syms, jsyms = pdcch.pdcch_modulate(cfg, dci), jax_pdcch.pdcch_modulate(jcfg, dci)
        assert (syms.dtype, syms.shape) == (jsyms.dtype, jsyms.shape)
        np.testing.assert_array_equal(syms, jsyms)


def test_encodes_build_one_table_per_shape(monkeypatch):
    """100 slots' worth of random DCIs, RNTIs, scrambling ids, SFNs and MIBs:
    one PDCCH table for (40 DCI bits, E = 432) and one PBCH table, each built
    from one run of the chain per input bit and one for the offset, and one
    SSB cell part per half-frame bit, so no per-slot value enters a key."""
    runs = {"pdcch": 0, "pbch": 0}

    def counted(name, chain):
        def run(*args):
            runs[name] += 1
            return chain(*args)
        return run

    monkeypatch.setattr(pdcch, "TABLES", gf2.TableCache(pdcch._build_table))
    monkeypatch.setattr(pbch, "TABLES", gf2.TableCache(
        lambda: gf2.build_table(pbch._encode_chain, pbch.A)))
    monkeypatch.setattr(pdcch, "_encode_chain", counted("pdcch", pdcch._encode_chain))
    monkeypatch.setattr(pbch, "_encode_chain", counted("pbch", pbch._encode_chain))
    pbch._ssb_cell_part.cache_clear()
    rng = np.random.default_rng(11)
    for _ in range(100):
        rnti, n_id, n_rnti = (int(x) for x in rng.integers(0, 65536, 3))
        cfg = pdcch.PdcchCandidateConfig(nof_dci_bits=40, aggregation_level=4, rnti=rnti,
                                         n_id=n_id, n_rnti=n_rnti)
        pdcch.pdcch_symbol_pairs(cfg, rng.integers(0, 2, 40).astype(np.uint8))
        pbch.ssb_block_pairs(pbch.PbchMessage(
            sfn=int(rng.integers(0, 1024)), ssb_idx=0, half_radio_frame=bool(rng.integers(0, 2)),
            n_id=1, mib_payload=tuple(int(b) for b in rng.integers(0, 2, 24))))
    assert pdcch.TABLES.keys() == [(40, 432)] and pbch.TABLES.keys() == [()]
    assert runs == {"pdcch": 40 + pdcch.RNTI_LEN + 1, "pbch": pbch.A + 1}
    assert pbch._ssb_cell_part.cache_info().currsize == 2


def test_pdcch_dmrs_and_mapping_equal():
    from srsran_projectvtlmo_tpu.ran import pdcch_mapping as jax_map
    from srsran_projectvtlmo_tpu_torch.ran import pdcch_mapping

    for slot, sym, dur, n_id in ((0, 0, 1, 0), (7, 1, 2, 1), (19, 2, 3, 65535)):
        regs = pdcch_mapping.cce_to_reg_interleaved(48, dur, 6, 2, 5, 4, 1) if dur != 1 else \
            pdcch_mapping.cce_to_reg_interleaved(48, 1, 6, 2, 0, 4, 0)
        assert regs == (jax_map.cce_to_reg_interleaved(48, dur, 6, 2, 5, 4, 1) if dur != 1 else
                        jax_map.cce_to_reg_interleaved(48, 1, 6, 2, 0, 4, 0))
        prbs = pdcch_mapping.pdcch_coreset_prbs(regs, dur, 3 + np.arange(48))
        np.testing.assert_array_equal(pdcch.pdcch_dmrs_values(slot, sym, dur, prbs, n_id),
                                      jax_pdcch.pdcch_dmrs_values(slot, sym, dur, prbs, n_id))
        for a, b in zip(pdcch_mapping.pdcch_re_indices(prbs, dur, sym, 624),
                        jax_map.pdcch_re_indices(prbs, dur, sym, 624)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- CSI-RS --

@pytest.mark.parametrize("row", range(1, 19))
def test_csi_rs_pattern_equal(row):
    """Every mapping-table row, at densities one/three and both halves of 0.5."""
    densities = ("three",) if row == 1 else ("one", "dot5_even", "dot5_odd")
    for density in densities:
        kw = dict(nof_rb=10, prb_start=3, row=row, k_ref=(0, 2, 4, 6, 8, 10)[:csi_rs.ROW_NOF_KREF[row]],
                  symbol=4, symbol_l1=9, density=density, scrambling_id=77, slot=5)
        a = csi_rs.csi_rs_pattern(csi_rs.CsiRsConfig(**kw))
        b = jax_csi_rs.csi_rs_pattern(jax_csi_rs.CsiRsConfig(**kw))
        assert len(a) == len(b) == csi_rs.ROW_PORTS[row]
        for (s0, c0, v0), (s1, c1, v1) in zip(a, b):
            np.testing.assert_array_equal(s0, s1)
            np.testing.assert_array_equal(c0, c1)
            np.testing.assert_array_equal(v0, v1)


def test_csi_rs_sequence_and_map_equal():
    cfg = dict(nof_rb=24, prb_start=2, symbol=5, subcarrier_offset=3, scrambling_id=41, slot=6)
    np.testing.assert_array_equal(csi_rs.csi_rs_sequence(csi_rs.CsiRsConfig(**cfg)),
                                  jax_csi_rs.csi_rs_sequence(jax_csi_rs.CsiRsConfig(**cfg)))
    a, b = np.zeros((14, 26 * 12), np.complex64), np.zeros((14, 26 * 12), np.complex64)
    csi_rs.map_csi_rs(a, csi_rs.CsiRsConfig(**cfg))
    jax_csi_rs.map_csi_rs(b, jax_csi_rs.CsiRsConfig(**cfg))
    np.testing.assert_array_equal(a, b)
    assert np.count_nonzero(a) == 24


# ------------------------------------------------------ the dynamic SCH chain --

_SCH = [
    # Uneven E groups (G not a multiple of C * Qm * L), several codeblocks.
    dict(nof_rb=24, modulation=Modulation.QAM256, target_code_rate=0.8, nof_layers=2,
         dmrs_symbols=(2,)),
    dict(nof_rb=13, modulation=Modulation.QAM16, target_code_rate=0.5, nof_layers=1,
         dmrs_symbols=(2, 11)),
    # BG2 with filler bits.
    dict(nof_rb=6, modulation=Modulation.QPSK, target_code_rate=0.3, nof_layers=1,
         dmrs_symbols=(2,)),
]


@pytest.mark.parametrize("kw", _SCH, ids=["qam256_2layer", "qam16", "qpsk_bg2"])
def test_sch_dyn_chain_equal_for_every_rv(kw):
    """For rv 0-3 and two UEs: the transmitted codeword bits (the port's bit
    planes) equal the JAX static chain's scrambled codeword, and the symbols
    equal the JAX dynamic chain's with the rv one-hot.  The host helpers
    (k0', scrambling planes, rate-match indices) are equal too."""
    from srsran_projectvtlmo_tpu.models.sch_config import SchChainConfig as JaxSchConfig
    from srsran_projectvtlmo_tpu_torch.models.sch_config import SchChainConfig

    cfg, jcfg = SchChainConfig(**port_kw(kw)), JaxSchConfig(**kw)
    qm = bits_per_symbol(kw["modulation"])
    groups = sch_tx.sch_rate_match_groups(cfg)
    assert groups == jax_sch_tx.sch_rate_match_groups(jcfg)
    rng = np.random.default_rng(cfg.nof_rb)
    tb = rng.integers(0, 2, (2, cfg.tbs)).astype(np.uint8)
    planes_tx = sch_tx.build_sch_planes_tx_dyn(cfg)
    sym_tx = sch_tx.build_sch_symbols_tx_dyn(cfg)
    jdyn = jax_sch_tx.build_sch_symbols_tx_dyn(jcfg)
    for rv in range(4):
        assert sch_tx.sch_k0_prime(cfg, rv) == jax_sch_tx.sch_k0_prime(jcfg, rv)
        for a, b in zip(sch_tx.sch_rate_match_indices(cfg, rv),
                        jax_sch_tx.sch_rate_match_indices(jcfg, rv)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for rnti, n_id in ((0x4601, 1), (0x1234, 77)):
            scr = sch_tx.sch_scramble_planes(cfg, rnti, n_id)
            jscr = jax_sch_tx.sch_scramble_planes(jcfg, rnti, n_id)
            for a, b in zip(scr, jscr):
                np.testing.assert_array_equal(a, b)
            k0p = sch_tx.sch_k0_prime(cfg, rv)
            planes = planes_tx(torch.as_tensor(tb), tuple(torch.as_tensor(s) for s in scr), k0p)
            # The JAX static chain: rate-matched, interleaved, scrambled bits.
            vcfg = dataclasses.replace(jcfg, rv=rv, rnti=rnti, n_id=n_id)
            cw = np.asarray(jax_sch_tx.build_sch_codeword_tx(vcfg)(jnp.asarray(tb)))
            cw = cw ^ jax_prg.gold_sequence_bits(vcfg.scrambling_cinit(), cfg.nof_codeword_bits)
            off = 0
            for (e, js), p in zip(groups, planes):
                want = cw[:, off:off + len(js) * e].reshape(2, len(js), e // qm, qm)
                np.testing.assert_array_equal(p.numpy(), want.transpose(0, 1, 3, 2),
                                              err_msg=f"rv {rv}")
                off += len(js) * e
            onehot = jnp.asarray(np.eye(4, dtype=np.uint8)[rv])
            want_sym = np.asarray(jdyn(jnp.asarray(tb), tuple(jnp.asarray(s) for s in jscr),
                                       onehot))
            got_sym = sym_tx(torch.as_tensor(tb), tuple(torch.as_tensor(s) for s in scr), k0p)
            np.testing.assert_allclose(got_sym.numpy(), want_sym, atol=1e-6, err_msg=f"rv {rv}")
    # One row per rv in a single batched call equals the per-rv calls.
    scr = tuple(torch.as_tensor(np.stack([s] * 4)) for s in sch_tx.sch_scramble_planes(cfg, 7, 3))
    tb4 = torch.as_tensor(np.concatenate([tb, tb]))
    k0s = [sch_tx.sch_k0_prime(cfg, rv) for rv in range(4)]
    both = sym_tx(tb4, scr, k0s)
    for rv in range(4):
        one = sym_tx(tb4[rv:rv + 1], tuple(s[0] for s in scr), k0s[rv])
        np.testing.assert_array_equal(both[rv:rv + 1].numpy(), one.numpy())


# ---------------------------------------------------------------- PDSCH Tx --

def test_pdsch_tx_config_and_slot_equal():
    """`PdschTxConfig` sizes (with a CSI-RS reservation) equal JAX's, and
    the single-layer PDSCH slot's grid and samples match the JAX program."""
    from srsran_projectvtlmo_tpu.ran import re_pattern as jax_re_pattern
    from srsran_projectvtlmo_tpu_torch.ran import re_pattern

    kw = dict(nof_rb=12, modulation=Modulation.QAM64, target_code_rate=0.6, rnti=0x77, n_id=5,
              start_symbol=0, rb_start=3, dft_size=512, numerology=1, slot=3,
              dmrs_symbols=(2, 11))
    csi = dict(nof_rb=8, prb_start=4, row=1, k_ref=(1,), symbol=5, density="three")
    reserved = re_pattern.csi_rs_patterns(csi_rs.CsiRsConfig(**csi))
    jreserved = jax_re_pattern.csi_rs_patterns(jax_csi_rs.CsiRsConfig(**csi))
    assert reserved == tuple(re_pattern.RePattern(**dataclasses.asdict(p)) for p in jreserved)
    a = pdsch_tx.PdschTxConfig(**port_kw(kw), reserved=reserved)
    b = jax_pdsch_tx.PdschTxConfig(**kw, reserved=jreserved)
    assert (a.nof_data_re, a.tbs, a.nof_codeword_bits, a.cb_rate_match_sizes()) == \
        (b.nof_data_re, b.tbs, b.nof_codeword_bits, b.cb_rate_match_sizes())
    assert a.nof_data_re == 12 * 12 * 12 - 8 * 3

    cfg, jcfg = pdsch_tx.PdschTxConfig(**port_kw(kw)), jax_pdsch_tx.PdschTxConfig(**kw)
    tb = np.random.default_rng(1).integers(0, 2, (2, cfg.tbs)).astype(np.uint8)
    grid, samples = pdsch_tx.pdsch_tx_slot(torch.as_tensor(tb), cfg)
    jgrid, jsamples = jax_pdsch_tx.pdsch_tx_slot(jnp.asarray(tb), jcfg)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=1e-6)
    jsamples = np.asarray(jsamples)
    err = np.sqrt(np.mean((samples.numpy() - jsamples) ** 2) / np.mean(jsamples ** 2))
    assert err < 1e-5, err


_DMRS = _vectors("dmrs")


@pytest.mark.parametrize("key", sorted(k for k in _DMRS if k.split("_")[-1] == "1"
                                       and k.split("_")[1] == "0"))
def test_pdsch_dmrs_matches_reference(key):
    """The DL slot's PDSCH DM-RS values (type 1, n_SCID 0: what a PDSCH PDU
    carries) against the reference's sequences."""
    n_id, _, slot, symbol, nof_rb, rb_start, _ = (int(v) for v in key[1:].split("_"))
    cell = CellConfig(nof_rb=rb_start + nof_rb, dft_size=4096)
    start = min(symbol, 12)
    pdu = PdschPdu(rnti=1, rb_start=rb_start, rb_size=nof_rb, modulation=port_mod(Modulation.QPSK),
                   target_code_rate=0.3, start_symbol=start, nof_symbols=14 - start,
                   dmrs_symbols=(symbol,), n_id=n_id)
    request = DlTtiRequest(slot=slot, pdsch=(pdu,))
    program = dl_slot.get_dl_slot_program(request, cell, "cpu")
    values = dl_slot.build_dl_slot_inputs(program, request, None, slot)
    np.testing.assert_allclose(_pair_c(values[1][0][0]), _pair_c(_DMRS[key]), atol=1e-7)
