"""PyTorch port, PUCCH formats 0/1/2, PRACH, SRS and low-PAPR sequences,
module by module against the JAX package and against the stored reference-C++
vectors (as `tests/test_reference_parity.py` reads them).

Signals are made on the host from a numpy seed with the port's own sequence
generators (`ops/low_papr`, `ops/prg`, `ops/uci.uci_encode`, `ops/prach`), as
`tests/test_pucch.py` and `tests/test_prach_detector.py` make them; the same
numpy inputs go through the JAX function and the port's.

Tolerances and why:
  * detected bits, SR flags, valid flags, detected preamble sets: equal;
  * PUCCH and PRACH detection metrics: rtol 1e-4 (float32 complex sums in
    another order; every input sits far from the > 1.0 threshold);
  * PRACH timing advance of a detected preamble: equal (the peak lag of a
    clear correlation peak);
  * SRS channel, noise, EPRE and TA, PRACH (de)modulation: rtol 1e-4 with an
    absolute floor of 1e-5 of the values' scale (float32 FFTs and
    estimator arithmetic in another order).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.ops import low_papr as jax_low_papr
from srsran_projectvtlmo_tpu.ops import ofdm as jax_ofdm
from srsran_projectvtlmo_tpu.ops import prach as jax_prach
from srsran_projectvtlmo_tpu.ops import srs as jax_srs
from srsran_projectvtlmo_tpu.phy import pucch as jax_pucch

from srsran_projectvtlmo_tpu_torch.ops import low_papr, ofdm, prach, prg, srs
from srsran_projectvtlmo_tpu_torch.ops import uci as uci_mod
from srsran_projectvtlmo_tpu_torch.phy import pucch
from srsran_projectvtlmo_tpu_torch.utils.cplx import np_to_pair

T = torch.as_tensor
VECTORS = Path(__file__).parent / "vectors"


def _close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()), 1.0))


def _noisy(tx: np.ndarray, nof_ports: int, noise: float, rng) -> np.ndarray:
    """(P, *tx.shape) complex64: tx through one random gain per port, plus
    complex AWGN of standard deviation `noise` per component."""
    h = (rng.normal(size=nof_ports) + 1j * rng.normal(size=nof_ports)) / np.sqrt(2) + 0.5
    rx = h.reshape((-1,) + (1,) * tx.ndim) * tx[None]
    rx = rx + noise * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
    return rx.astype(np.complex64)


# ------------------------------------------------------- signal generators --
# Host generators of each channel's transmitted REs, shared with
# tests/test_torch_upper_phy.py.

def f0_signal(cfg: pucch.PucchFormat0Config, bits) -> np.ndarray:
    """(S, 12) format-0 REs carrying `bits` (HARQ-ACK; none = SR only)."""
    if len(bits) == 2:
        mcs = (0, 3, 9, 6)[2 * bits[0] + bits[1]]  # Gray: (b0, b1) 00, 01, 10, 11
    else:
        mcs = 6 * bits[0] if bits else 0
    u, v = low_papr.pucch_group_sequence(cfg.n_id)
    tx = np.empty((cfg.nof_symbols, 12), np.complex64)
    for s in range(cfg.nof_symbols):
        ncs = pucch._cyclic_shift_hopping(cfg.n_id, cfg.slot, cfg.start_symbol + s)
        alpha = 2 * np.pi * ((cfg.initial_cyclic_shift + mcs + ncs) % 12) / 12
        tx[s] = low_papr.low_papr_sequence(u, v, alpha, 12)
    return tx


def f1_signal(cfg: pucch.PucchFormat1Config, bits) -> np.ndarray:
    """(S, 12) format-1 REs carrying `bits`, each hop with its own OCC."""
    seqs, hops = pucch._f1_tables(cfg)
    if len(bits) == 1:
        d = (1 - 2 * bits[0]) / np.sqrt(2) * (1 + 1j)
    else:
        d = ((1 - 2 * bits[0]) + 1j * (1 - 2 * bits[1])) / np.sqrt(2)
    tx = np.zeros((cfg.nof_symbols, 12), np.complex64)
    for w_data, w_dmrs, data_idx, dmrs_idx in hops:
        tx[dmrs_idx] = w_dmrs[:, None] * seqs[dmrs_idx]
        tx[data_idx] = d * w_data[:, None] * seqs[data_idx]
    return tx


def f2_signal(cfg: pucch.PucchFormat2Config, msg: np.ndarray) -> np.ndarray:
    """(S, 12 * nof_prb) format-2 REs carrying the UCI message `msg`."""
    prb, nsym = cfg.nof_prb, cfg.nof_symbols
    e = 16 * prb * nsym
    coded = uci_mod.uci_encode(msg, e, bits_per_symbol=2)
    scr = coded ^ prg.gold_sequence_bits(((cfg.rnti << 15) + cfg.n_id) & 0x7FFFFFFF, e)
    sym = (1 - 2 * scr[0::2].astype(np.float64)) + 1j * (1 - 2 * scr[1::2].astype(np.float64))
    tx = np.zeros((nsym, 12 * prb), np.complex64)
    tx[:, pucch._f2_data_subc(prb)] = (sym / np.sqrt(2)).reshape(nsym, 8 * prb)
    tx[:, pucch._f2_dmrs_subc(prb)] = pucch._f2_dmrs_ref(cfg)
    return tx


def srs_signal(cfg: srs.SrsConfig) -> np.ndarray:
    """(S, 12 * nof_rb) SRS REs of antenna port 0 on the comb."""
    tx = np.zeros((cfg.nof_symbols, cfg.nof_rb * 12), np.complex64)
    tx[:, srs.srs_subcarriers(cfg)] = srs.srs_sequence(cfg)
    return tx


def prach_occasion(cfg: prach.PrachDetectorConfig, preamble: int, nof_ports: int,
                   nof_symbols: int, snr_db: float, rng, delay: float = 0.0) -> np.ndarray:
    """(P, S, L) complex64 received occasion spectra: the preamble delayed by
    `delay` sequence samples through one random gain per port, unit noise."""
    freq = prach.prach_generate(cfg, preamble)
    freq = freq * np.exp(-2j * np.pi * np.arange(cfg.sequence_length) * delay
                         / cfg.sequence_length)
    h = (rng.normal(size=nof_ports) + 1j * rng.normal(size=nof_ports)) / np.sqrt(2)
    rx = 10.0 ** (snr_db / 20.0) * h[:, None, None] * np.broadcast_to(
        freq, (nof_ports, nof_symbols, cfg.sequence_length))
    rx = rx + (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape)) / np.sqrt(2)
    return rx.astype(np.complex64)


# ------------------------------------------------------------------- PUCCH --

F0_CASES = [  # (nof_harq_bits, sr_opportunity, bits sent, ports, noise only)
    (2, True, (1, 0), 1, False), (2, True, (0, 1), 4, False), (1, False, (1,), 4, False),
    (0, True, (), 1, False), (2, False, (1, 1), 4, True)]


@pytest.mark.parametrize("nharq,sr,bits,ports,noise_only", F0_CASES)
def test_pucch_format0_matches_jax(nharq, sr, bits, ports, noise_only):
    cfg = pucch.PucchFormat0Config(n_id=17 + ports, slot=3, start_symbol=12, nof_symbols=2,
                                   initial_cyclic_shift=4, nof_harq_bits=nharq,
                                   sr_opportunity=sr)
    rng = np.random.default_rng(nharq * 10 + ports)
    tx = f0_signal(cfg, bits) * (0.0 if noise_only else 1.0)
    rx = np_to_pair(_noisy(tx, ports, 0.05 if not noise_only else 0.5, rng))[None]
    want = jax_pucch.detect_pucch_format0(jnp.asarray(rx), jax_pucch.PucchFormat0Config(
        **vars(cfg)))
    got = pucch.detect_pucch_format0(T(rx), cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1].numpy(), want[1])
    metric = float(got[1][0])
    assert (metric < 0.5) if noise_only else (metric > 2.0), metric
    if not noise_only and bits:
        np.testing.assert_array_equal(got[0][0].numpy(), bits)


@pytest.mark.parametrize("bits,occ,hopping,ports,nsym", [
    ((0,), 0, False, 1, 14), ((1, 0), 2, False, 4, 14), ((1,), 1, True, 1, 14),
    ((0, 1), 1, True, 4, 10)])
def test_pucch_format1_matches_jax(bits, occ, hopping, ports, nsym):
    cfg = pucch.PucchFormat1Config(n_id=30, slot=1, start_symbol=14 - nsym, nof_symbols=nsym,
                                   initial_cyclic_shift=3, time_domain_occ=occ,
                                   nof_harq_bits=len(bits), intra_slot_hopping=hopping)
    rng = np.random.default_rng(occ + 10 * ports)
    rx = np_to_pair(_noisy(f1_signal(cfg, bits), ports, 0.05, rng))[None]
    want = jax_pucch.detect_pucch_format1(jnp.asarray(rx), jax_pucch.PucchFormat1Config(
        **vars(cfg)))
    got = pucch.detect_pucch_format1(T(rx), cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0][0].numpy(), bits)
    _close(got[1].numpy(), want[1])
    assert float(got[1][0]) > 2.0


@pytest.mark.parametrize("k,prb,nsym,ports", [(4, 1, 1, 1), (11, 2, 2, 4), (24, 4, 2, 1)])
def test_pucch_format2_matches_jax(k, prb, nsym, ports):
    cfg = pucch.PucchFormat2Config(n_id=9, n_id0=11, rnti=0x1234, slot=2,
                                   start_symbol=14 - nsym, nof_symbols=nsym, nof_prb=prb,
                                   nof_uci_bits=k)
    rng = np.random.default_rng(k)
    msg = rng.integers(0, 2, k).astype(np.uint8)
    rx = np_to_pair(_noisy(f2_signal(cfg, msg), ports, 0.05, rng))[None]
    want = jax_pucch.process_pucch_format2(jnp.asarray(rx), jax_pucch.PucchFormat2Config(
        **vars(cfg)))
    got = pucch.process_pucch_format2(T(rx), cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0][0].numpy(), msg)
    assert bool(got[1][0])


def test_pucch_hosts_tables_equal_jax():
    """The host tables behind the detectors: cyclic-shift hopping, F0
    candidates, F1 sequences and OCC weights, F2 pilots and RE layout."""
    for n_id, slot, sym in ((0, 0, 0), (17, 3, 12), (1007, 19, 5)):
        assert pucch._cyclic_shift_hopping(n_id, slot, sym) == \
            jax_pucch._cyclic_shift_hopping(n_id, slot, sym)
    np.testing.assert_array_equal(pucch._f0_candidates(9, 2, 12, 2, 3),
                                  jax_pucch._f0_candidates(9, 2, 12, 2, 3))
    for hopping in (False, True):
        kw = dict(n_id=7, slot=2, start_symbol=0, nof_symbols=14, initial_cyclic_shift=4,
                  time_domain_occ=1, nof_harq_bits=1, intra_slot_hopping=hopping)
        seqs, hops = pucch._f1_tables(pucch.PucchFormat1Config(**kw))
        jseqs, jw_data, jw_dmrs = jax_pucch._f1_tables(jax_pucch.PucchFormat1Config(**kw))
        np.testing.assert_array_equal(seqs, jseqs)
        for (w_data, w_dmrs, _, _), jd, jp in zip(hops, jw_data, jw_dmrs):
            np.testing.assert_array_equal(w_data, jd)
            np.testing.assert_array_equal(w_dmrs, jp)
    kw = dict(n_id=9, n_id0=11, rnti=0x1234, slot=2, start_symbol=12, nof_symbols=2,
              nof_prb=3, nof_uci_bits=7)
    np.testing.assert_array_equal(pucch._f2_dmrs_ref(pucch.PucchFormat2Config(**kw)),
                                  jax_pucch._f2_dmrs_ref(jax_pucch.PucchFormat2Config(**kw)))
    np.testing.assert_array_equal(pucch._f2_data_subc(3), jax_pucch._f2_data_subc(3))
    np.testing.assert_array_equal(pucch._f2_dmrs_subc(3), jax_pucch._f2_dmrs_subc(3))


def _vectors(name: str, suffix: str):
    with np.load(VECTORS / f"{name}_reference.npz") as z:
        data = {k: z[k] for k in z.files}
    return sorted({k[:-len(suffix)] for k in data if k.endswith(suffix)}), data


_P0_KEYS, _P0 = _vectors("pucch0", "_rx")
_P1_KEYS, _P1 = _vectors("pucch1", "_rx")
_P2_KEYS, _P2 = _vectors("pucch2", "_rx")
_PRACH_KEYS, _PRACH = _vectors("prach", "_in")
with np.load(VECTORS / "seq_reference.npz") as _z:
    _SEQ = {k: _z[k] for k in _z.files if k.startswith("papr_")}
    _PRG = {k: _z[k] for k in _z.files if k.startswith("prg_")}


@pytest.mark.parametrize("key", _P0_KEYS)
def test_pucch_format0_matches_reference_vectors(key):
    """Same detected bits and valid decision as the reference's
    pucch_detector_format0 (incl. DTX cases and 1/2/4-port combining)."""
    n_id, slot, l0, nsym, m0, nharq, _, _, _, _ = (int(v) for v in key[1:].split("_"))
    cfg = pucch.PucchFormat0Config(n_id=n_id, slot=slot, start_symbol=l0, nof_symbols=nsym,
                                   initial_cyclic_shift=m0, nof_harq_bits=nharq)
    bits, metric, _ = pucch.detect_pucch_format0(T(_P0[f"{key}_rx"][None]), cfg)
    valid = bool(metric[0] > 1.0)
    assert valid == bool(_P0[f"{key}_status"][0]), key
    if valid:
        np.testing.assert_array_equal(bits[0].numpy(), _P0[f"{key}_bits"], err_msg=key)


@pytest.mark.parametrize("key", _P1_KEYS)
def test_pucch_format1_matches_reference_vectors(key):
    """Same detected bits and valid decision as the reference's
    pucch_detector_impl (Walsh-ordered SF-4 OCC)."""
    n_id, slot, l0, nsym, m0, occ, nharq, _, _ = (int(v) for v in key[1:].split("_"))
    cfg = pucch.PucchFormat1Config(n_id=n_id, slot=slot, start_symbol=l0, nof_symbols=nsym,
                                   initial_cyclic_shift=m0, time_domain_occ=occ,
                                   nof_harq_bits=nharq)
    bits, metric = pucch.detect_pucch_format1(T(_P1[f"{key}_rx"][None]), cfg)
    valid = bool(metric[0] > 1.0)
    assert valid == bool(_P1[f"{key}_status"][0]), key
    if valid:
        np.testing.assert_array_equal(bits[0].numpy(), _P1[f"{key}_bits"], err_msg=key)


@pytest.mark.parametrize("key", _P2_KEYS)
def test_pucch_format2_matches_reference_vectors(key):
    """The reference's F2 demodulator and detector decode the same message."""
    nof_prb, nsym, l0, rnti, n_id, n_id0, k, _, _ = (int(v) for v in key[1:].split("_"))
    cfg = pucch.PucchFormat2Config(n_id=n_id, n_id0=n_id0, rnti=rnti, slot=2, start_symbol=l0,
                                   nof_symbols=nsym, nof_prb=nof_prb, nof_uci_bits=k)
    bits, ok = pucch.process_pucch_format2(T(_P2[f"{key}_rx"][None]), cfg)
    assert bool(ok[0]) == bool(_P2[f"{key}_valid"][0]), key
    np.testing.assert_array_equal(bits[0].numpy(), _P2[f"{key}_bits"], err_msg=key)


# ----------------------------------------------------------------- PRACH --

PRACH_CASES = {  # name -> (config keywords, preamble, ports, symbols, SNR dB, delay)
    "long_1port": (dict(sequence_length=839, root_sequence_index=0, zero_correlation_zone=1,
                        format="0"), 7, 1, 1, 0.0, 0.0),
    "long_4port_delay": (dict(sequence_length=839, root_sequence_index=22,
                              zero_correlation_zone=11, format="0"), 11, 4, 1, 3.0, 6.0),
    "long_2symbols": (dict(sequence_length=839, root_sequence_index=4, zero_correlation_zone=5,
                           format="1", combine_symbols=True), 3, 1, 2, -3.0, 0.0),
    "short_b4": (dict(sequence_length=139, root_sequence_index=1, zero_correlation_zone=11,
                      ncs_table="short", format="B4", numerology=1), 5, 2, 12, -6.0, 0.0),
}


@pytest.mark.parametrize("name", sorted(PRACH_CASES))
def test_prach_detect_matches_jax(name):
    kw, preamble, ports, nsym, snr, delay = PRACH_CASES[name]
    cfg = prach.PrachDetectorConfig(**kw)
    rng = np.random.default_rng(len(name))
    rx = np_to_pair(prach_occasion(cfg, preamble, ports, nsym, snr, rng, delay))[None]
    want = jax_prach.prach_detect(jnp.asarray(rx), jax_prach.PrachDetectorConfig(**kw))[0]
    got = prach.prach_detect(T(rx), cfg)[0]
    assert [d[0] for d in got] == [d[0] for d in want]
    assert max(got, key=lambda d: d[2])[0] == preamble
    for (_, ta, m), (_, jta, jm) in zip(got, want):
        assert ta == jta
        _close(m, jm)
    # The whole (B, nof_preambles) metric, detected or not.
    thr, margin, _ = prach.threshold_and_margin(ports, cfg.preamble.scs_hz, cfg.fmt,
                                                cfg.zero_correlation_zone, cfg.combine_symbols)
    nfft = 1024 if cfg.sequence_length == prach.LONG else 256
    metric, _ = prach._detect(T(rx), cfg, nfft, margin)
    jmetric, _ = jax_prach._detect_jit(jnp.asarray(rx), jax_prach.PrachDetectorConfig(**kw),
                                       nfft, margin)
    _close(metric.numpy(), jmetric)


def test_prach_tables_equal_jax():
    """Roots, window plan, thresholds and generated preambles."""
    for kw, *_ in PRACH_CASES.values():
        cfg, jcfg = prach.PrachDetectorConfig(**kw), jax_prach.PrachDetectorConfig(**kw)
        for a, b in zip(cfg.plan, jcfg.plan):
            np.testing.assert_array_equal(a, b)
        assert dataclasses.asdict(cfg.preamble) == dataclasses.asdict(jcfg.preamble)
        margin = 5
        nfft = 1024 if cfg.sequence_length == prach.LONG else 256
        ours = prach._detector_tables(cfg, nfft, margin)
        theirs = jax_prach._detector_tables(jcfg, nfft, margin)
        for a, b in zip(ours[:5], theirs):
            np.testing.assert_array_equal(a, b)
        for i in (0, 9, 63):
            np.testing.assert_array_equal(prach.prach_generate(cfg, i),
                                          jax_prach.prach_generate(jcfg, i))
    for args in ((1, 1.25e3, "0", 0, True), (4, 1.25e3, "0", 11, True), (2, 30e3, "B4", 11, True),
                 (64, 1.25e3, "0", 0, True), (3, 15e3, "C2", 1, False)):
        assert prach.threshold_and_margin(*args) == jax_prach.threshold_and_margin(*args)


@pytest.mark.parametrize("key", _PRACH_KEYS)
def test_prach_detect_matches_reference_vectors(key):
    """The reference's prach_detector_generic_impl on the same occasion:
    identical detected preamble set, TA within two detector resolutions."""
    parts = key.split("_")
    lng = parts[0] == "l1"
    length, scs = (839, 1250.0) if lng else (139, 15000.0)
    cfg = prach.PrachDetectorConfig(sequence_length=length,
                                    root_sequence_index=int(parts[1][1:]),
                                    zero_correlation_zone=int(parts[2][1:]),
                                    ncs_table="1.25kHz" if lng else "short")
    dets = prach.prach_detect(T(_PRACH[f"{key}_in"][None, :, None]), cfg)[0]
    ours = {i: ta for i, ta, _ in dets}
    refs = {int(r[0]): float(r[1]) for r in _PRACH[f"{key}_det"]}
    assert set(ours) == set(refs), f"detected {sorted(ours)} vs reference {sorted(refs)}"
    ta_res_ns = float(_PRACH[f"{key}_ta_res_ns"])
    for idx, ref_ta_ns in refs.items():
        assert abs(ours[idx] * 1e9 / (length * scs) - ref_ta_ns) <= 2 * ta_res_ns + 1e-6


@pytest.mark.parametrize("length,scs,fs,offset", [(839, 1250.0, 7.68e6, 7), (139, 30e3, 7.68e6, 2)])
def test_prach_modulate_demodulate_match_jax(length, scs, fs, offset):
    rng = np.random.default_rng(length)
    freq = np_to_pair((rng.normal(size=(2, 3, length))
                       + 1j * rng.normal(size=(2, 3, length))).astype(np.complex64))
    time = ofdm.prach_modulate(T(freq), length, offset, scs, fs)
    _close(time.numpy(), jax_ofdm.prach_modulate(jnp.asarray(freq), length, offset, scs, fs))
    back = ofdm.prach_demodulate(time, length, offset, scs, fs)
    _close(back.numpy(), jax_ofdm.prach_demodulate(jnp.asarray(time.numpy()), length, offset,
                                                   scs, fs))
    _close(back.numpy(), freq)
    assert ofdm.prach_window_samples(length, scs, fs) == jax_ofdm.prach_window_samples(
        length, scs, fs)


# ------------------------------------------------------------------- SRS --

@pytest.mark.parametrize("nof_rb,comb,ports,nsym", [(8, 2, 1, 1), (12, 4, 4, 2), (24, 2, 4, 1)])
def test_srs_estimate_matches_jax(nof_rb, comb, ports, nsym):
    kw = dict(nof_rb=nof_rb, comb_size=comb, comb_offset=comb - 1, start_symbol=14 - nsym,
              nof_symbols=nsym, sequence_id=nof_rb + 3, cyclic_shift=1)
    cfg = srs.SrsConfig(**kw)
    rng = np.random.default_rng(nof_rb)
    rx = np_to_pair(_noisy(srs_signal(cfg), ports, 0.02, rng))[None]
    want = jax_srs.srs_estimate(jnp.asarray(rx), jax_srs.SrsConfig(**kw))
    got = srs.srs_estimate(T(rx), cfg)
    for key in ("ce_pair", "noise_var", "epre", "ta_s"):
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key].numpy(), want[key])
    np.testing.assert_array_equal(srs.srs_subcarriers(cfg), jax_srs.srs_subcarriers(
        jax_srs.SrsConfig(**kw)))
    for port in range(2):
        np.testing.assert_array_equal(srs.srs_sequence(cfg, port),
                                      jax_srs.srs_sequence(jax_srs.SrsConfig(**kw), port))


# -------------------------------------------------------------- low PAPR --

def test_low_papr_matches_jax():
    for m in (6, 12, 18, 24, 36, 48, 96, 144):
        for u in (0, 7, 29):
            for v in ((0, 1) if m >= 72 else (0,)):
                for alpha in (0.0, 2 * np.pi * 5 / 12):
                    np.testing.assert_array_equal(
                        low_papr.low_papr_sequence(u, v, alpha, m),
                        jax_low_papr.low_papr_sequence(u, v, alpha, m))
    for n_id in (0, 301, 1007):
        for slot in (0, 3):
            kw = dict(group_hopping=True, slot=slot, hop=1)
            assert low_papr.pucch_group_sequence(n_id, **kw) == \
                jax_low_papr.pucch_group_sequence(n_id, **kw)
        assert low_papr.pucch_group_sequence(n_id) == jax_low_papr.pucch_group_sequence(n_id)


@pytest.mark.parametrize("key", sorted(_SEQ))
def test_low_papr_matches_reference_vectors(key):
    """The reference's low_papr_sequence_generator_impl, every length family."""
    _, u, v, an, ad, ln = (int(x) if i else x for i, x in enumerate(key.split("_")))
    ref = _SEQ[key][:, 0] + 1j * _SEQ[key][:, 1]
    np.testing.assert_allclose(low_papr.low_papr_sequence(u, v, 2.0 * np.pi * an / ad, ln),
                               ref, atol=2e-6, err_msg=key)


@pytest.mark.parametrize("key", sorted(_PRG))
def test_gold_sequence_matches_reference_vectors(key):
    """The Gold sequence behind PUCCH hopping, F2 and DM-RS pilots against
    the reference's LFSR generator, fast-advance offsets included."""
    _, cinit, adv, n = (int(x) if i else x for i, x in enumerate(key.split("_")))
    np.testing.assert_array_equal(prg.gold_sequence_bits(cinit, adv + n)[adv:].astype(np.uint8),
                                  _PRG[key], err_msg=key)

