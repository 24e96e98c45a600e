"""PyTorch port, PUSCH receive stages against the JAX package on the same
numpy inputs, and against the stored reference-C++ vectors: rate recovery
and HARQ combining, soft demapping, EVM, channel and time-alignment
estimation, MMSE equalization and OFDM."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.ops import channel_estimate as jax_est
from srsran_projectvtlmo_tpu.ops import demodulation as jax_demod
from srsran_projectvtlmo_tpu.ops import equalization as jax_eq
from srsran_projectvtlmo_tpu.ops import evm as jax_evm
from srsran_projectvtlmo_tpu.ops import modulation as jax_mod
from srsran_projectvtlmo_tpu.ops import ofdm as jax_ofdm
from srsran_projectvtlmo_tpu.ops import time_alignment as jax_ta
from srsran_projectvtlmo_tpu.ops.ldpc import rate_match as jax_rm
from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph
from srsran_projectvtlmo_tpu.ran.modulation import Modulation

from srsran_projectvtlmo_tpu_torch.ops import (channel_estimate, demodulation, equalization,
                                               evm, modulation, ofdm, time_alignment)
from srsran_projectvtlmo_tpu_torch.ops.ldpc import rate_match as rm
from tests.test_torch_host_copies import port_mod

VEC = Path(__file__).parent / "vectors"
T = torch.as_tensor


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _load(name):
    with np.load(VEC / name) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------------ rate recovery --

_RM_CASES = [  # (bg, z, filler, rv, e, qm): no-wrap slices, wrap, repetition
    (BaseGraph.BG1, 384, 96, 0, 8960, 8), (BaseGraph.BG1, 384, 96, 0, 8976, 8),
    (BaseGraph.BG1, 64, 20, 2, 3000, 6), (BaseGraph.BG1, 64, 20, 3, 2400, 4),
    (BaseGraph.BG2, 40, 16, 1, 2400, 2), (BaseGraph.BG2, 40, 0, 0, 900, 2),
]


@pytest.mark.parametrize("case", _RM_CASES)
def test_rate_dematch_and_harq_combine_bit_exact(case):
    bg, z, f, rv, e, qm = case
    rng = np.random.default_rng(e)
    llr = rng.integers(-128, 128, (2, 3, e)).astype(np.int8)
    x4 = np.ascontiguousarray(llr.reshape(2, 3, e // qm, qm).transpose(0, 3, 1, 2))
    want = np.asarray(jax_rm.rate_dematch_bit_major(jnp.asarray(x4), bg, z, f, rv, e, qm))
    got = rm.rate_dematch_bit_major(T(x4), bg, z, f, rv, e, qm).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rm.rate_dematch(T(llr), bg, z, f, rv, e, qm).numpy(),
                                  np.asarray(jax_rm.rate_dematch(jnp.asarray(llr), bg, z, f, rv, e, qm)))
    np.testing.assert_array_equal(rm.rate_match_plan(bg, z, f, rv, e, qm),
                                  jax_rm.rate_match_plan(bg, z, f, rv, e, qm))
    # HARQ combining keeps the reference's clamp-after-sum semantics.
    buf = rng.integers(-128, 128, want.shape).astype(np.int8)
    want = want.copy()
    buf[0, 0, :50] = 127
    np.testing.assert_array_equal(rm.harq_combine(T(buf), T(want)).numpy(),
                                  np.asarray(jax_rm.harq_combine(jnp.asarray(buf), jnp.asarray(want))))


_RMV = _load("ldpc_rate_match_reference.npz")
_RMV_KEYS = sorted({k.rsplit("_", 1)[0] for k in _RMV})


@pytest.mark.parametrize("key", _RMV_KEYS)
def test_rate_match_and_dematch_match_reference_vectors(key):
    p = key.split("_")
    bg, z, rv, qm, e, f = (BaseGraph(int(p[0][2:])), int(p[1][1:]), int(p[2][2:]),
                           int(p[3][2:]), int(p[4][1:]), int(p[5][1:]))
    np.testing.assert_array_equal(
        rm.rate_match(T(_RMV[f"{key}_cw"][None]), bg, z, f, rv, e, qm).numpy()[0],
        _RMV[f"{key}_rm"])
    np.testing.assert_array_equal(
        rm.rate_dematch(T(_RMV[f"{key}_llr"][None]), bg, z, f, rv, e, qm).numpy()[0],
        _RMV[f"{key}_dm"])


# ------------------------------------------------------------------ demap --

_MODS = [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64, Modulation.QAM256,
         Modulation.BPSK, Modulation.PI_2_BPSK]


@pytest.mark.parametrize("mod", _MODS, ids=lambda m: m.name)
def test_demap_tables_equal(mod):
    tmod = port_mod(mod)
    np.testing.assert_array_equal(modulation.constellation(tmod), jax_mod.constellation(mod))
    for a, b in zip(demodulation.demap_tables(tmod), jax_demod._demap_tables(mod)):
        np.testing.assert_array_equal(a, b)
    ta, tb = demodulation.demap_axis_tables(tmod), jax_demod._demap_axis_tables(mod)
    assert (ta is None) == (tb is None)
    if ta is not None:
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(a, b)
        assert demodulation.demap_min_plan(tmod) == jax_demod._demap_min_plan(mod)


@pytest.mark.parametrize("mod", _MODS, ids=lambda m: m.name)
def test_soft_demap_matches_jax(mod):
    """Both layouts, on identical float32 symbols and noise variances.  Equal
    int8 except at quantization ties: a float32 metric that lands within an
    ulp of a rounding midpoint may round the other way (+/-1 LSB); counted."""
    rng = np.random.default_rng(5)
    sym = (rng.normal(size=(2, 7, 300, 2)) * 0.8).astype(np.float32)
    nv = np.abs(rng.normal(0.05, 0.03, (2, 7, 300))).astype(np.float32)
    nv[0, 0, :3] = 0.0  # degenerate variance demaps to 0
    for bit_major in (False, True):
        want = np.asarray(jax_demod.soft_demap(jnp.asarray(sym), jnp.asarray(nv), mod,
                                               bit_major=bit_major)).astype(np.int32)
        got = demodulation.soft_demap(T(sym), T(nv), port_mod(mod), bit_major=bit_major).numpy()
        assert got.shape == want.shape and got.dtype == np.int8
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= 1 and (diff > 0).sum() <= 2, (bit_major, (diff > 0).sum())


_DEMAP = _load("demap_reference.npz")


@pytest.mark.parametrize("key", sorted({k.rsplit("_", 1)[0] for k in _DEMAP}))
def test_soft_demap_within_one_lsb_of_reference(key):
    mod = {2: Modulation.QPSK, 4: Modulation.QAM16, 6: Modulation.QAM64,
           8: Modulation.QAM256}[int(key.split("_")[0][2:])]
    ours = demodulation.soft_demap(T(_DEMAP[f"{key}_sym"][None]), T(_DEMAP[f"{key}_nvar"][None]),
                                   port_mod(mod)).numpy()[0].astype(np.int32)
    assert np.abs(ours - _DEMAP[f"{key}_llr"].astype(np.int32)).max() <= 1


@pytest.mark.parametrize("mod", [Modulation.QAM256, Modulation.QAM16, Modulation.BPSK],
                         ids=lambda m: m.name)
def test_evm_matches_jax(mod):
    rng = np.random.default_rng(6)
    sym = (rng.normal(size=(3, 500, 2)) * 0.7).astype(np.float32)
    want = np.asarray(jax_evm.evm(jnp.asarray(sym), mod))
    np.testing.assert_allclose(evm.evm(T(sym), port_mod(mod)).numpy(), want, rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------- estimation --

def _pilots(rng, shape, delay_re=0.7, cfo_phase=0.3):
    """Pilots through a smooth two-tap channel with delay and a CFO phase
    step between DM-RS symbols, plus noise; (rx pair, ref pair)."""
    ndmrs, npil = shape[-2:]
    ref = np.exp(1j * np.pi / 4 * (2 * rng.integers(0, 4, (ndmrs, npil)) + 1)).astype(np.complex64)
    k = np.arange(npil)
    h = (1.0 + 0.4 * np.exp(-2j * np.pi * k * 3 / npil)) * np.exp(-2j * np.pi * k * delay_re / 64)
    rot = np.exp(1j * cfo_phase * np.arange(ndmrs))[:, None]
    y = ref * h * rot
    y = y + 0.03 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    to_pair = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)
    return to_pair(y), to_pair(ref)


@pytest.mark.parametrize("nof_rb,ndmrs,stride", [(24, 2, 2), (24, 1, 2), (12, 2, 4), (1, 1, 2)])
def test_estimate_channel_hop_matches_jax(nof_rb, ndmrs, stride):
    """float32 tolerance: both sides run the same float32 formulas in another
    summation/FFT order, so estimates agree to ~1e-6 relative; rtol 1e-4 /
    atol 1e-5 (scaled to the channel) leaves margin.  TA is an argmax over a
    4096-point IDFT: equal, or one resolution sample apart on a near tie."""
    rng = np.random.default_rng(nof_rb * 10 + ndmrs)
    npil = 12 * nof_rb // stride
    y, ref = _pilots(rng, (3, 2, ndmrs, npil))
    epochs = tuple(float(e) for e in (np.arange(ndmrs) * 9 * 35.68e-6 + 2.4e-6))
    want = jax_est.estimate_channel_hop(jnp.asarray(y), jnp.asarray(ref), nof_rb, stride, 30e3,
                                        epochs)
    got = channel_estimate.estimate_channel_hop(T(y), T(ref), nof_rb, stride, 30e3, epochs)
    scale = float(np.abs(np.asarray(want["ce_pair"])).max())
    np.testing.assert_allclose(got["ce_pair"].numpy(), np.asarray(want["ce_pair"]),
                               rtol=1e-4, atol=1e-5 * scale)
    for key in ("noise_var", "rsrp", "epre"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["cfo_hz"].numpy(), np.asarray(want["cfo_hz"]),
                               rtol=1e-4, atol=1e-2)
    assert np.abs(got["time_alignment_s"].numpy()
                  - np.asarray(want["time_alignment_s"])).max() <= 1.0 / (4096 * 30e3) + 1e-12
    np.testing.assert_array_equal(channel_estimate.rc_filter(nof_rb, stride),
                                  jax_est.rc_filter(nof_rb, stride))


_EST = _load("est_reference.npz")


@pytest.mark.parametrize("key", sorted(k[:-len("_stats")] for k in _EST if k.endswith("_stats")))
def test_estimator_matches_reference_vectors(key):
    """Same checks and tolerances as the JAX package's reference-vector test."""
    meta = _EST[f"{key}_meta"]
    nof_rb, ndmrs = int(meta[0]), int(meta[2])
    epochs = tuple(float(e) for e in _EST[f"{key}_epochs"])
    out = channel_estimate.estimate_channel_hop(T(_EST[f"{key}_rx"][None]), T(_EST[f"{key}_pilots"]),
                                                nof_rb, 2, 30e3, epochs)
    nv_ref, rsrp_ref, epre_ref, snr_ref, ta_ref, cfo_ref = _EST[f"{key}_stats"]
    nv, rsrp = float(out["noise_var"][0]), float(out["rsrp"][0])
    np.testing.assert_allclose(nv, nv_ref, rtol=1e-3)
    np.testing.assert_allclose(rsrp, rsrp_ref, rtol=1e-4)
    np.testing.assert_allclose(float(out["epre"][0]), epre_ref, rtol=1e-4)
    np.testing.assert_allclose(rsrp / nv, snr_ref, rtol=2e-3)
    assert abs(float(out["time_alignment_s"][0]) - ta_ref) <= 1.0 / (4096 * 30e3) + 1e-12
    if ndmrs >= 2:
        np.testing.assert_allclose(float(out["cfo_hz"][0]), cfo_ref, rtol=1e-3, atol=0.5)
    ce_ref = _EST[f"{key}_ce_dmrs"]
    ce_ref_c = ce_ref[:, 0] + 1j * ce_ref[:, 1]
    ce = out["ce_pair"][0].numpy()
    ce_c = (ce[:, 0] + 1j * ce[:, 1]) * np.exp(2j * np.pi * epochs[0] * cfo_ref)
    np.testing.assert_allclose(ce_c, ce_ref_c, atol=np.abs(ce_ref_c).max() * 2.0 ** -7)


def test_time_alignment_matches_jax():
    """Same peak bin; the seconds agree to one float32 ulp (XLA may divide by
    the constant as a multiply by its reciprocal)."""
    rng = np.random.default_rng(9)
    k = np.arange(96)
    lse = np.exp(-2j * np.pi * k * rng.uniform(-5, 5, (4, 1)) / 384)
    pair = np.stack([lse.real, lse.imag], -1).astype(np.float32)
    want = np.asarray(jax_ta.estimate_time_alignment(jnp.asarray(pair), 2, 30e3))
    np.testing.assert_allclose(time_alignment.estimate_time_alignment(T(pair), 2, 30e3).numpy(),
                               want, rtol=2e-7, atol=0)


# ----------------------------------------------------------- equalization --

@pytest.mark.parametrize("nports,nlayers", [(1, 1), (4, 1), (4, 2), (2, 2), (4, 3), (4, 4)])
def test_mmse_weights_and_apply_match_jax(nports, nlayers):
    """float32 elementwise formulas (L <= 2) or a 3x3/4x4 complex inverse:
    rtol 1e-4 / atol 1e-5 relative to the weights' scale."""
    rng = np.random.default_rng(nports * 10 + nlayers)
    s = 48
    h = rng.normal(size=(2, s, nports, nlayers, 2)).astype(np.float32)
    nv = rng.uniform(0.01, 0.1, (2, nports)).astype(np.float32)
    w_j, nv_j = jax_eq.mmse_weights(jnp.asarray(h), jnp.asarray(nv))
    w_t, nv_t = equalization.mmse_weights(T(h), T(nv))
    w_j = np.asarray(w_j)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=1e-4, atol=1e-5 * np.abs(w_j).max())
    np.testing.assert_allclose(nv_t.numpy(), np.asarray(nv_j), rtol=1e-4, atol=1e-7)
    y = rng.normal(size=(2, nports, 5, s, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (2, 5))
    rot = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    for r in (None, rot):
        want = np.asarray(jax_eq.apply_weights_ports_first(
            jnp.asarray(w_j), jnp.asarray(y), None if r is None else jnp.asarray(r)))
        got = equalization.apply_weights_ports_first(T(w_j), T(y), None if r is None else T(r))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


_EQ = _load("eq_reference.npz")


@pytest.mark.parametrize("key", sorted({k.rsplit("_", 1)[0] for k in _EQ if k.startswith("mmse")}))
def test_mmse_matches_reference_vectors(key):
    """The reference's MMSE 1xN closed form (equalize_mmse_1xn.h), same
    tolerance as the JAX package's test."""
    rx, est, nvar = _EQ[f"{key}_rx"], _EQ[f"{key}_est"], _EQ[f"{key}_nvar"]
    h = T(np.ascontiguousarray(np.transpose(est, (2, 0, 1, 3))))[None]  # (1, nre, P, L, 2)
    w, nv = equalization.mmse_weights(h, T(nvar)[None])
    y = T(np.ascontiguousarray(rx))[None, :, None]  # (1, P, 1, nre, 2)
    sym = equalization.apply_weights_ports_first(w, y)[0, 0].numpy()
    np.testing.assert_allclose(sym, _EQ[f"{key}_eq"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(nv[0].numpy(), _EQ[f"{key}_eqnv"], rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------------- OFDM --

@pytest.mark.parametrize("dft,mu,slot", [(512, 1, 0), (512, 1, 1), (4096, 1, 0), (2048, 0, 0),
                                         (1024, 2, 3)])
def test_cp_lengths_equal(dft, mu, slot):
    assert ofdm.cp_lengths(dft, mu, slot) == jax_ofdm.cp_lengths(dft, mu, slot)
    assert ofdm.cp_lengths(dft, mu, slot, "extended") == jax_ofdm.cp_lengths(dft, mu, slot, "extended")
    assert ofdm.slot_sample_count(dft, mu, slot) == jax_ofdm.slot_sample_count(dft, mu, slot)


@pytest.mark.parametrize("slot,fc", [(0, 0.0), (1, 3.5e9)])
def test_ofdm_demodulate_and_modulate_match_jax(slot, fc):
    """Demodulation to a bf16 grid agrees within one bf16 ulp (the FFTs differ
    in the last float32 bits, which can move a bf16 rounding), or within the
    float32 FFT noise (1e-6 of the grid's peak) for values near zero; the
    float32 modulator within float32 FFT noise."""
    rng = np.random.default_rng(slot)
    nsubc, dft = 288, 512
    n = jax_ofdm.slot_sample_count(dft, 1, slot)
    x = rng.normal(size=(2, 3, n, 2)).astype(np.float32)
    want = np.asarray(jax_ofdm.ofdm_demodulate(jnp.asarray(x), nsubc, dft, 1, slot, fc,
                                               out_dtype="bf16")).astype(np.float32)
    got = _np(ofdm.ofdm_demodulate(T(x), nsubc, dft, 1, slot, fc, out_dtype="bf16"))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= np.maximum(ulp, 1e-6 * np.abs(want).max())).all()
    f32 = _np(ofdm.ofdm_demodulate(T(x), nsubc, dft, 1, slot, fc))
    np.testing.assert_allclose(f32, np.asarray(jax_ofdm.ofdm_demodulate(jnp.asarray(x), nsubc, dft,
                                                                        1, slot, fc)),
                               rtol=0, atol=1e-5)
    g = rng.normal(size=(2, 14, nsubc, 2)).astype(np.float32)
    want_s = np.asarray(jax_ofdm.ofdm_modulate(jnp.asarray(g), dft, 1, slot, fc))
    np.testing.assert_allclose(ofdm.ofdm_modulate(T(g), dft, 1, slot, fc).numpy(), want_s,
                               rtol=0, atol=1e-5 * np.abs(want_s).max())


_OFDM = _load("ofdm_reference.npz")


@pytest.mark.parametrize("key", sorted(k[:-len("_grid")] for k in _OFDM if k.endswith("_grid")))
def test_ofdm_matches_reference_vectors(key):
    """Modulator and demodulator against the reference OFDM, same tolerance
    as the JAX package's test (the reference DFT is unnormalized)."""
    p = key.split("_")
    rb, dft, slot, fc = int(p[0][2:]), int(p[1][3:]), int(p[2][4:]), float(p[3][2:]) * 1e6
    ref_s = _OFDM[f"{key}_samples"]
    mine = ofdm.ofdm_modulate(T(_OFDM[f"{key}_grid"]), dft, 1, slot, center_freq_hz=fc).numpy()
    np.testing.assert_allclose(mine, ref_s, atol=np.abs(ref_s).max() * 2e-6)
    ref_d = _OFDM[f"{key}_demod"]
    demod = ofdm.ofdm_demodulate(T(ref_s), rb * 12, dft, 1, slot, center_freq_hz=fc).numpy()
    np.testing.assert_allclose(demod * np.float32(dft), ref_d, atol=np.abs(ref_d).max() * 2e-6)
