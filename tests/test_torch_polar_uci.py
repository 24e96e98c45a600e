"""PyTorch port, UCI channel coding: polar code (allocate, encode, rate match
and dematch, the SSC decoder), short-block codes and the UCI encoder/decoder,
each held against the JAX package on the same numpy-seeded inputs and against
the reference C++ vectors (`tests/vectors/polar_reference.npz`,
`short_block_reference.npz`).

Tolerances and why:
  * bits, allocations, codewords, dematched LLRs, decoded bits, CRC
    verdicts: equal (integer and bit work; the decoder's min-sum runs in
    float32 on integer-valued LLRs in both, so every value is exact).
  * the short-block detection metric: within rtol 1e-5 (its correlations are
    exact integers in both; the energy normalisation sums in another order).

The polar codes here stay at N <= 256, apart from the 2-codeblock split
(N = 512 per codeblock), which is held bit-exact against JAX's encoder and
decoded back by the port; its JAX decode is the one slow case.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.ops import polar as jax_polar
from srsran_projectvtlmo_tpu.ops import short_block as jax_sb
from srsran_projectvtlmo_tpu.ops import uci as jax_uci
from srsran_projectvtlmo_tpu.ops.polar import rate_matching as jax_prm
from srsran_projectvtlmo_tpu.ops.polar.interleave import deinterleave, interleave

from srsran_projectvtlmo_tpu_torch.ops import polar, short_block, uci
from srsran_projectvtlmo_tpu_torch.ops.polar import decode as polar_decode_mod
from srsran_projectvtlmo_tpu_torch.ops.polar import rate_matching as prm

VECTORS = Path(__file__).parent / "vectors"
# The JAX functions run jitted: op-by-op dispatch would compile each op.
J_ALLOCATE = jax.jit(jax_polar.polar_allocate, static_argnums=1)
J_ENCODE = jax.jit(jax_polar.polar_encode, static_argnums=1)
J_RATE_MATCH = jax.jit(jax_prm.rate_match, static_argnums=1)
J_RATE_DEMATCH = jax.jit(jax_prm.rate_dematch, static_argnums=1)
J_DETECT = jax.jit(jax_sb.detect, static_argnums=(1, 2))
J_UCI_DECODE = jax.jit(jax_uci.uci_decode, static_argnums=1)

#: (K, E): PC bits with and without the extra PC bit (K <= 25, E > K + 189),
#: puncturing (20, 100), (24, 230), (40, 200), shortening (31, 60), (40, 80)
#: and repetition (E > N) (64, 130), (20, 300), all at N <= 256.
_CODES = [(20, 100), (24, 230), (40, 200), (31, 60), (40, 80), (64, 130), (20, 300)]


def _pair(k, e):
    return polar.PolarCode(K=k, E=e, n_max=10, ibil=True), \
        jax_polar.PolarCode(K=k, E=e, n_max=10, ibil=True)


@pytest.mark.parametrize("k,e", _CODES)
def test_polar_tx_chain_bit_exact_vs_jax(k, e):
    code, jcode = _pair(k, e)
    assert code.N <= 256
    msg = np.random.default_rng(k * e).integers(0, 2, (5, k)).astype(np.uint8)
    u = polar.polar_allocate(torch.as_tensor(msg), code)
    np.testing.assert_array_equal(polar.pc_matrix(code), jax_polar.pc_matrix(jcode))
    np.testing.assert_array_equal(u.numpy(), np.asarray(J_ALLOCATE(jnp.asarray(msg), jcode)))
    np.testing.assert_array_equal(polar.polar_deallocate(u, code).numpy(), msg)
    x = polar.polar_encode(u, code.n)
    np.testing.assert_array_equal(x.numpy(), np.asarray(J_ENCODE(jnp.asarray(u.numpy()), jcode.n)))
    np.testing.assert_array_equal(prm.tx_plan(code), jax_prm.tx_plan(jcode))
    np.testing.assert_array_equal(prm.rate_match(x, code).numpy(),
                                  np.asarray(J_RATE_MATCH(jnp.asarray(x.numpy()), jcode)))


@pytest.mark.parametrize("k,e", _CODES)
def test_polar_rx_chain_bit_exact_vs_jax(k, e):
    """Dematch and decode random int8 LLRs (zeros included, so the decoder's
    ties are met) and a noisy codeword that decodes back to its message."""
    code, jcode = _pair(k, e)
    rng = np.random.default_rng(k + e)
    msg = rng.integers(0, 2, (3, k)).astype(np.uint8)
    cw = prm.rate_match(polar.polar_encode(polar.polar_allocate(torch.as_tensor(msg), code),
                                           code.n), code).numpy()
    noisy = np.clip((1 - 2 * cw.astype(np.int32)) * 40 + rng.integers(-30, 31, cw.shape),
                    -127, 127).astype(np.int8)
    llr = np.concatenate([noisy, rng.integers(-127, 128, (4, e)).astype(np.int8),
                          rng.integers(-1, 2, (2, e)).astype(np.int8)])
    buf = prm.rate_dematch(torch.as_tensor(llr), code)
    jbuf = np.asarray(J_RATE_DEMATCH(jnp.asarray(llr), jcode))
    assert buf.dtype == torch.int8
    np.testing.assert_array_equal(buf.numpy(), jbuf)
    u = polar.polar_decode(buf, code)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax_polar.polar_decode(jnp.asarray(jbuf),
                                                                                jcode)))
    np.testing.assert_array_equal(polar.polar_deallocate(u, code).numpy()[:3], msg)
    kinds = polar_decode_mod.count_nodes(code)
    assert sum(kinds.values()) < 2 * code.N - 1  # the tree is pruned


def test_rate_dematch_promotes_repeats_and_fills_shortened():
    """Repeats beyond +/-120 promote to +/-127; shortened positions read +127."""
    rep, _ = _pair(20, 300)  # E > N: repetition
    assert rep.E > rep.N
    buf = prm.rate_dematch(torch.full((1, rep.E), 70, dtype=torch.int8), rep)
    assert int((buf == 127).sum()) == rep.E - rep.N and int((buf == 70).sum()) == 2 * rep.N - rep.E
    short, _ = _pair(40, 80)  # 16K > 7E: shortening
    assert short.E < short.N and 16 * short.K > 7 * short.E
    buf = prm.rate_dematch(torch.zeros((1, short.E), dtype=torch.int8), short)
    assert int((buf == 127).sum()) == short.N - short.E


with np.load(VECTORS / "polar_reference.npz") as _pz:
    _POLAR = {k: _pz[k] for k in _pz.files}
_POLAR_KEYS = sorted({k.rsplit("_", 1)[0] for k in _POLAR})


def _code_of(key):
    k, e, nmax, ibil = key.split("_")[:4]
    return polar.PolarCode(K=int(k[1:]), E=int(e[1:]), n_max=int(nmax[1:]),
                           ibil=bool(int(ibil[4:])))


@pytest.mark.parametrize("key", _POLAR_KEYS)
def test_polar_chain_matches_reference_vectors(key):
    """The reference C++ polar chain (polar_encoder_impl.cpp, rate matcher
    and dematcher, the SSC decoder); the downlink input interleaver is the
    JAX package's, applied to numpy bits."""
    code = _code_of(key)
    msg_i = np.array(interleave(jnp.asarray(_POLAR[f"{key}_msg"][None]), code.K))
    u = polar.polar_allocate(torch.as_tensor(msg_i), code)
    np.testing.assert_array_equal(u.numpy()[0], _POLAR[f"{key}_alloc"])
    enc = polar.polar_encode(u, code.n)
    np.testing.assert_array_equal(enc.numpy()[0], _POLAR[f"{key}_enc"])
    np.testing.assert_array_equal(prm.rate_match(enc, code).numpy()[0], _POLAR[f"{key}_rm"])
    dem = prm.rate_dematch(torch.as_tensor(_POLAR[f"{key}_llr"][None]), code)
    np.testing.assert_array_equal(dem.numpy()[0].astype(np.int32),
                                  _POLAR[f"{key}_dematch"].astype(np.int32))
    msg_hat = polar.polar_deallocate(polar.polar_decode(dem, code), code).numpy()
    np.testing.assert_array_equal(np.asarray(deinterleave(jnp.asarray(msg_hat), code.K))[0],
                                  _POLAR[f"{key}_dec"])


def test_short_block_tables_equal_jax():
    np.testing.assert_array_equal(short_block.BASIS, jax_sb.BASIS)
    rng = np.random.default_rng(0)
    for k in range(1, 12):
        for bps in (1, 2, 4, 6, 8):
            for e in (bps * 3 * 2, 32, 61):
                msg = rng.integers(0, 2, k).astype(np.uint8)
                np.testing.assert_array_equal(short_block.encode_host(msg, e, bps),
                                              jax_sb.encode_host(msg, e, bps))
    np.testing.assert_array_equal(short_block._codebook(4, 40, 2), jax_sb._codebook(4, 40, 2))


@pytest.mark.parametrize("k", range(1, 12))
def test_short_block_detect_vs_jax(k):
    """Random LLRs (many ties between codewords at small K) and noisy
    codewords: equal bits, metric within rtol 1e-5."""
    rng = np.random.default_rng(k)
    for bps, e in ((1, 48), (2, 40), (4, 96), (8, 64)):
        msg = rng.integers(0, 2, (3, k)).astype(np.uint8)
        cw = np.stack([short_block.encode_host(m, e, bps) for m in msg])
        noisy = np.clip((1 - 2 * cw.astype(np.int32)) * 30 + rng.integers(-40, 41, cw.shape),
                        -127, 127).astype(np.int8)
        llr = np.concatenate([noisy, rng.integers(-127, 128, (4, e)).astype(np.int8),
                              rng.integers(-1, 2, (2, e)).astype(np.int8)])
        bits, metric = short_block.detect(torch.as_tensor(llr), k, bps)
        jbits, jmetric = J_DETECT(jnp.asarray(llr), k, bps)
        assert bits.dtype == torch.uint8 and metric.dtype == torch.float32
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_allclose(metric.numpy(), np.asarray(jmetric), rtol=1e-5, atol=0)
        np.testing.assert_array_equal(bits.numpy()[:3], msg)


with np.load(VECTORS / "short_block_reference.npz") as _sz:
    _SHORT = {k: _sz[k] for k in _sz.files}
_SHORT_KEYS = sorted({k[:-len("_msg")] for k in _SHORT if k.endswith("_msg")})


@pytest.mark.parametrize("key", _SHORT_KEYS)
def test_short_block_matches_reference_vectors(key):
    """short_block_encoder_impl / short_block_detector_impl: the reference
    leaves placeholders as sentinels (255 = x, 254 = y), resolved here as the
    encoder resolves them inline (x -> 1, y -> the previous bit)."""
    k, e, bps = (int(p.lstrip("kebps")) for p in key.split("_")[:3])
    ref = _SHORT[f"{key}_enc"].copy()
    for i, b in enumerate(ref):
        ref[i] = 1 if b == 255 else (ref[i - 1] if b == 254 else b)
    np.testing.assert_array_equal(short_block.encode_host(_SHORT[f"{key}_msg"], e, bps), ref)
    bits, _ = short_block.detect(torch.as_tensor(_SHORT[f"{key}_llr"].astype(np.int8)[None]), k,
                                 bps)
    if int(_SHORT[f"{key}_valid"][0]):
        np.testing.assert_array_equal(bits.numpy()[0], _SHORT[f"{key}_det"])


@pytest.mark.parametrize("k,e", [(3, 24), (12, 60), (19, 90), (20, 100)])
def test_uci_encode_decode_vs_jax(k, e):
    """Short block (K <= 11), CRC6 (K <= 19) and CRC11 polar: the encoders
    agree, and noisy and random LLRs decode to the same bits and verdicts."""
    assert uci.nof_uci_codeblocks(k, e) == jax_uci.nof_uci_codeblocks(k, e) == 1
    assert uci.uci_crc_size(k) == jax_uci.uci_crc_size(k)
    rng = np.random.default_rng(k)
    msg = rng.integers(0, 2, (2, k)).astype(np.uint8)
    cw = np.stack([uci.uci_encode(m, e) for m in msg])
    np.testing.assert_array_equal(cw, np.stack([jax_uci.uci_encode(m, e) for m in msg]))
    if k >= 12:
        np.testing.assert_array_equal(uci.polar_uci_encode(torch.as_tensor(msg), e).numpy(), cw)
    noisy = np.clip((1 - 2 * cw.astype(np.int32)) * 30 + rng.integers(-45, 46, cw.shape),
                    -127, 127).astype(np.int8)
    llr = np.concatenate([noisy, rng.integers(-127, 128, (3, e)).astype(np.int8)])
    bits, ok = uci.uci_decode(torch.as_tensor(llr), k)
    jbits, jok = J_UCI_DECODE(jnp.asarray(llr), k)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(bits.numpy()[:2], msg)
    assert ok.numpy()[:2].all()


_SPLIT = [(361, 1100), (400, 1200)]  # odd K: one filler bit before codeblock 0


@pytest.mark.parametrize("k,e", _SPLIT)
def test_uci_two_codeblock_split(k, e):
    """K >= 360 and E >= 1088: two codeblocks, filler bits prepended to the
    first.  The device encoder equals JAX's host encoder bit for bit, and the
    port's decoder returns the message with a passing CRC on both halves and
    a failing one when a half is corrupted."""
    assert uci.nof_uci_codeblocks(k, e) == jax_uci.nof_uci_codeblocks(k, e) == 2
    rng = np.random.default_rng(k)
    msg = rng.integers(0, 2, (2, k)).astype(np.uint8)
    cw = uci.polar_uci_encode(torch.as_tensor(msg), e).numpy()
    np.testing.assert_array_equal(cw, np.stack([jax_uci.uci_encode(m, e) for m in msg]))
    llr = ((1 - 2 * cw.astype(np.int32)) * 20).astype(np.int8)
    llr[1, e // 2:] = -llr[1, e // 2:]
    bits, ok = uci.uci_decode(torch.as_tensor(llr), k)
    np.testing.assert_array_equal(bits.numpy()[0], msg[0])
    assert ok.numpy().tolist() == [True, False]


@pytest.mark.slow
@pytest.mark.parametrize("k,e", _SPLIT)
def test_uci_two_codeblock_decode_vs_jax(k, e):
    """The 2-codeblock decode on noisy LLRs against JAX's (N = 512 traces)."""
    rng = np.random.default_rng(e)
    msg = rng.integers(0, 2, (2, k)).astype(np.uint8)
    cw = uci.polar_uci_encode(torch.as_tensor(msg), e).numpy()
    llr = np.clip((1 - 2 * cw.astype(np.int32)) * 30 + rng.integers(-50, 51, cw.shape),
                  -127, 127).astype(np.int8)
    bits, ok = uci.uci_decode(torch.as_tensor(llr), k)
    jbits, jok = J_UCI_DECODE(jnp.asarray(llr), k)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
